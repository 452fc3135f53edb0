"""Multi-place parallelism: the sharded global-tier table over a grid of
places with flush-time reductions, the collective import fold, and the
collective forward's plane exchange (see ``sharded`` for the design)."""

from veneur_tpu_torch.parallel.sharded import (  # noqa: F401
    SHARD, SERIES, CollectiveWireFold, Mesh, ShardedAggregator,
    ShardedConfig, ShardedTable, default_places, empty_state,
    init_process_mesh, make_import_mesh, make_merge_step, make_mesh,
    make_update_step, mesh_process_count, readout)
