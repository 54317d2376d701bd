from .base import Decoder, DecodeStats, decode, batchdecode
from .bp import BeliefPropagationDecoder
from .bposd import BeliefPropagationOSDDecoder

__all__ = [
    "Decoder",
    "DecodeStats",
    "decode",
    "batchdecode",
    "BeliefPropagationDecoder",
    "BeliefPropagationOSDDecoder",
]
