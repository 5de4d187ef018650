from .cbr import CbrEncoderModel
from .common import EncodedSamples, EncoderBaseState
from .decoder import DecoderModel
from .vbr import VbrEncoderModel

__all__ = ["EncodedSamples", "EncoderBaseState", "CbrEncoderModel", "VbrEncoderModel", "DecoderModel"]
