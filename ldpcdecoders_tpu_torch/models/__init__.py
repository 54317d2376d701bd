from .base import Decoder, DecodeStats, decode, batchdecode, decode_soft
from .bitflip import BitFlipDecoder
from .bp import BeliefPropagationDecoder
from .bucketed import BucketedDecoder
from .bposd import BeliefPropagationOSDDecoder
from .bpots import BPOTSDecoder
from .css import CSSDecoder
from .demwindow import WindowedDemDecoder
from .detector import DetectorGraphDecoder, load_dem
from .ensemble import EnsembleDecoder
from .layered import LayeredMinSumDecoder
from .minsum import MinSumDecode, MinSumDecoder
from .minsum_q import QuantizedMinSumDecoder
from .mixed import MixedChannelDecoder
from .neural import NeuralMinSumDecoder
from .peeling import ErasurePeelingDecoder
from .qc_minsum import QCMinSumDecoder
from .spacetime import SpaceTimeDecoder
from .window import SlidingWindowDecoder
from .staged import StagedDemDecoder

__all__ = [
    "Decoder",
    "DecodeStats",
    "decode",
    "batchdecode",
    "decode_soft",
    "BeliefPropagationDecoder",
    "BeliefPropagationOSDDecoder",
    "BitFlipDecoder",
    "BPOTSDecoder",
    "CSSDecoder",
    "MinSumDecoder",
    "MinSumDecode",
    "LayeredMinSumDecoder",
    "QuantizedMinSumDecoder",
    "BucketedDecoder",
    "ErasurePeelingDecoder",
    "MixedChannelDecoder",
    "NeuralMinSumDecoder",
    "SlidingWindowDecoder",
    "WindowedDemDecoder",
    "QCMinSumDecoder",
    "SpaceTimeDecoder",
    "DetectorGraphDecoder",
    "load_dem",
    "EnsembleDecoder",
    "StagedDemDecoder",
]
