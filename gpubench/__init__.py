"""The benchmark of rodio_tpu_torch, the PyTorch and CUDA port, on NVIDIA
cards: ``python3 gpubench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` (see ``gpubench/README.md``)."""
