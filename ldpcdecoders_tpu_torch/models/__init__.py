from .base import Decoder, DecodeStats, decode, batchdecode, decode_soft
from .bp import BeliefPropagationDecoder
from .bposd import BeliefPropagationOSDDecoder
from .detector import DetectorGraphDecoder, load_dem
from .ensemble import EnsembleDecoder
from .minsum import MinSumDecode, MinSumDecoder
from .qc_minsum import QCMinSumDecoder
from .spacetime import SpaceTimeDecoder
from .staged import StagedDemDecoder

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
    "DetectorGraphDecoder",
    "load_dem",
    "EnsembleDecoder",
    "StagedDemDecoder",
]
