"""Run-time flags of the port's models, after the reference's
``models/flags.py``.  The reference's other flags steer XLA tracing
(scan unrolling, MoE dispatch, the direct-attention size limit) and have
no counterpart here."""

# Rematerialize the chunked-CE loss head in backward instead of saving each
# chunk's (B, c, V) f32 logits (checkpoint per chunk).  Off by default.
CE_REMAT = False
