from .base import Decoder, DecodeStats, decode, batchdecode, decode_soft
from .bp import BeliefPropagationDecoder
from .bposd import BeliefPropagationOSDDecoder
from .minsum import MinSumDecode, MinSumDecoder
from .qc_minsum import QCMinSumDecoder
from .spacetime import SpaceTimeDecoder

__all__ = [
    "Decoder",
    "DecodeStats",
    "decode",
    "batchdecode",
    "decode_soft",
    "BeliefPropagationDecoder",
    "BeliefPropagationOSDDecoder",
    "MinSumDecoder",
    "MinSumDecode",
    "QCMinSumDecoder",
    "SpaceTimeDecoder",
]
