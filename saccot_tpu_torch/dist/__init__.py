"""Distributed estimator over `torch.distributed` process groups.

- ``mesh``         process-group init and the ("pairs", "hyp", "corr") mesh
- ``collectives``  tiled all-gather, all-reduce and the ring hop
- ``ring``         ring-scheduled degrees over the correspondence axis (SP)
- ``sweep``        DP over pairs x TP over hypotheses x SP over correspondences
- ``local``        a launcher that spawns ranks on this host

The sharded estimator bodies themselves are `engine.sac_cot.register_batch_sp`
and `register_batch_tp`.
"""
