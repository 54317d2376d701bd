"""Numeric clamp constants of the LLR-domain tanh-rule decoders.

Counterpart of ``ldpcdecoders_tpu/ops/clamps.py``: tanh values are clamped
to +/-TANH_CLAMP and messages to +/-MSG_CLAMP.
"""

TANH_CLAMP = 0.99999
MSG_CLAMP = 100.0
