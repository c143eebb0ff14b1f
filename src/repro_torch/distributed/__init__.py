from repro_torch.distributed.sharding import (  # noqa: F401
    RULE_SETS,
    axis_rules,
    current_context,
    logical_to_pspec,
    shard,
    sharding_for,
)
