from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingCtx, agree_all, constrain, current_ctx, make_rules, param_specs,
    spec_for, use_sharding,
)
