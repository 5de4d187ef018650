from .cbr import CbrEncoderModel
from .common import EncodedSamples, EncoderBaseState
from .decoder import DecoderModel

__all__ = ["EncodedSamples", "EncoderBaseState", "CbrEncoderModel", "DecoderModel"]
