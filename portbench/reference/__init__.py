"""Plain references of the configurations' decoders (torch and numpy only).

Each module a configuration names under ``"reference"`` has
``decode_stated(matrix, priors, settings, syndromes, device) -> dict``.  None
imports the program (``ldpcdecoders_tpu_torch``) or JAX.
"""
