"""The port's conversions: the counterparts of rodio_tpu.conversions."""
from .blockdtype import Bf16Boundary
from .channels import RechannelNode, rechannel_block
from .resample import Resample, resample_output_frames
from .uniform import Uniform

__all__ = ["Bf16Boundary", "RechannelNode", "Resample", "Uniform",
           "rechannel_block", "resample_output_frames"]
