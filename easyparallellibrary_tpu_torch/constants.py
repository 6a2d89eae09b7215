"""Framework-wide constants.

TPU-native analog of the reference's ``epl/utils/constant.py`` (op-type lists,
name prefixes, comm defaults).  Here the constants are mesh-axis names, fusion
defaults and collection keys instead of TF op-type tables.
"""

# ---------------------------------------------------------------------------
# Canonical mesh axis names.  Every sharding in the framework is expressed in
# terms of these logical axes of a single `jax.sharding.Mesh`:
#
#   stage  — pipeline stages             (reference: consecutive `replicate`
#            scopes become taskgraphs, epl/ir/taskgraph.py:107)
#   data   — data-parallel replicas      (reference: replica cloning,
#            epl/parallel/graph_editor.py:423-443)
#   seq    — sequence/context parallel   (absent in the reference; SURVEY §5.7)
#   expert — expert parallelism for MoE  (reference: split + alltoall,
#            epl/parallel/hooks.py:758-794)
#   model  — tensor-parallel shards      (reference: `split`,
#            epl/strategies/split.py:49)
#
# `model` is innermost (fastest-varying over devices) so tensor-parallel
# collectives ride the shortest ICI hops; `stage` is outermost so pipeline
# point-to-point traffic crosses the slowest links.
# ---------------------------------------------------------------------------
STAGE_AXIS = "stage"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"

# Mesh axis order, outermost → innermost.
MESH_AXES = (STAGE_AXIS, DATA_AXIS, SEQ_AXIS, EXPERT_AXIS, MODEL_AXIS)

# Environment-variable prefix for config overrides (reference:
# epl/config.py:283-287 uses EPL_<CATEGORY>_<ATTR>).
ENV_PREFIX = "EPL"

# Communication fusion defaults (reference: epl/utils/constant.py:81-82 —
# 32 MB buckets, max 60 splits; epl/config.py:88 — 2 communicators).
DEFAULT_FUSION_BUCKET_MB = 32
DEFAULT_MAX_FUSION_SPLITS = 60
DEFAULT_NUM_COMMUNICATORS = 2

# Sharded checkpoint bucket bound (reference: epl/runtime/saver.py:148).
DEFAULT_SAVE_SHARD_MB = 50

# Collection keys for cross-replica metric merging (reference:
# epl/ir/graph.py:40-64 GraphKeys merge collections).
class GraphKeys:
  GLOBAL_MEAN_OBJECTS = "global_mean_objects"
  GLOBAL_SUM_OBJECTS = "global_sum_objects"
  GLOBAL_CONCAT_OBJECTS = "global_concat_objects"
  LOCAL_MEAN_OBJECTS = "local_mean_objects"
  LOCAL_SUM_OBJECTS = "local_sum_objects"
  LOCAL_CONCAT_OBJECTS = "local_concat_objects"

  ALL_MERGE_KEYS = (
      GLOBAL_MEAN_OBJECTS,
      GLOBAL_SUM_OBJECTS,
      GLOBAL_CONCAT_OBJECTS,
      LOCAL_MEAN_OBJECTS,
      LOCAL_SUM_OBJECTS,
      LOCAL_CONCAT_OBJECTS,
  )


# Pipeline schedule names (reference: epl/strategies/scheduler.py:120-124).
SCHEDULE_PREFER_FORWARD = "PreferForward"        # GPipe-like
SCHEDULE_PREFER_BACKWARD = "PreferBackward"      # 1F1B-like
SCHEDULE_PREFER_BACKWARD_OPT = "PreferBackwardOptimizer"

# ZeRO levels (reference: epl/config.py:129-137 — v0 = opt states,
# v1 = + gradients; v2 declared unimplemented there).
ZERO_V0 = "v0"
ZERO_V1 = "v1"

# AMP levels (reference: epl/config.py:148-159).
AMP_O0 = "O0"   # off
AMP_O1 = "O1"   # mixed precision (bf16 compute on TPU)

# Offload levels (reference: epl/config.py:140-146).
OFFLOAD_V0 = "v0"

# Gradient-checkpoint selection modes (reference: epl/runtime/gc/
# gradient_checkpoint.py:114-120).
GC_COLLECTION = "collection"
GC_AUTO = "auto"

# Sequence-parallel modes (new subsystem; SURVEY §5.7).
SEQ_PARALLEL_RING = "ring"
SEQ_PARALLEL_ULYSSES = "ulysses"
