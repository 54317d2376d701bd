from .base import Decoder, DecodeStats, decode, batchdecode, decode_soft
from .bp import BeliefPropagationDecoder
from .bposd import BeliefPropagationOSDDecoder
from .minsum import MinSumDecode, MinSumDecoder

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
]
