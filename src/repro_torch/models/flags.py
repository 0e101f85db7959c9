"""Run-time flags of the port's models, after the reference's
``models/flags.py``.  The reference's other flags steer XLA tracing
(scan unrolling, the direct-attention size limit) and have no
counterpart here; nor has ``MOE_CONSTRAIN_DISPATCH``, which only puts
sharding constraints on the MoE dispatch's intermediates."""

# Gather-based MoE when tokens * top_k <= num_experts (decode steps) instead
# of the capacity dispatch: each token multiplies its top-k experts' weights
# only, with no capacity padding.  Off by default, as in the reference, so
# the capacity dispatch is what a decode step runs.
MOE_GATHER_DECODE = False

# Rematerialize the chunked-CE loss head in backward instead of saving each
# chunk's (B, c, V) f32 logits (checkpoint per chunk).  Off by default.
CE_REMAT = False
