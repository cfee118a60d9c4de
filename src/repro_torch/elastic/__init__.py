"""Elastic N-to-M recovery: repartition a checkpoint onto a new world size
(port of ``repro.elastic``).

A checkpoint created on N ranks restores onto M != N ranks with minimal data
movement (Ham et al.'s N-to-M algorithm, TeaMPI-style substitution).

  plan.py     — pure planner: old shard coordinates -> new-rank row segments
  reshard.py  — executors: host slicing and the row gather on the card (B6)

Entry point: CheckpointEngine.restore_elastic(new_n_ranks).
"""

from repro_torch.elastic.plan import (  # noqa: F401
    ElasticReport,
    LeafTarget,
    RepartitionPlan,
    Segment,
    new_world_targets,
    plan_repartition,
)
from repro_torch.elastic.reshard import (  # noqa: F401
    reshard_leaf_device,
    reshard_leaves,
    reshard_leaves_device,
)
