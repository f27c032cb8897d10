"""The training and communication layer of the port (counterpart of
paddle_tpu.parallel): the train step on one GPU or over a mesh of ranks
(`make_train_step(mesh=)` over dp, ZeRO's ``sharding`` and
tensor-parallel ``mp``; `make_eval_step`; `DataParallel`;
`group_sharded_parallel`), the ranks and their process groups (`ranks`,
`mesh`, `env`), the collectives as graph operators and the quantized wire
(`collectives`), the semi-auto API over a rank's blocks (`placement`,
`api`, `spmd_rules`), the Megatron layers (`mpu`), Paddle's collective
API on torch tensors (`collective`), the sharded checkpoint
(`checkpoint`, whose block record is ``checkpoint.Shard``), pipeline
parallelism over pp (`pipeline_spmd`'s five schedules, `pipeline`'s
layer API, `pipeline_viz`), sequence and context parallelism over sep
(`sequence_parallel`, `ulysses`, `ring_attention`) and the pass
registry (`passes`)."""
from . import mpu  # noqa: F401
from .api import (dtensor_from_fn, get_placements,  # noqa: F401
                  reshard, shard_constraint, shard_layer, shard_optimizer,
                  shard_tensor, unshard_dtensor)
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401
from .collectives import quantized_psum_tree  # noqa: F401
from .data_parallel import DataParallel, scale_batch  # noqa: F401
from .env import ParallelEnv, get_rank, get_world_size  # noqa: F401
from .fused_optimizer import FusedOptimizer  # noqa: F401
from .mesh import (HybridCommunicateGroup, build_mesh,  # noqa: F401
                   get_global_mesh, set_global_mesh)
from .placement import (Partial, Placement, ProcessMesh,  # noqa: F401
                        Replicate, Shard)
from .sharding import (group_sharded_parallel,  # noqa: F401
                       save_group_sharded_model, shard_accumulators,
                       shard_params_stage3)
from .spmd_rules import (get_spmd_rule, register_spmd_rule,  # noqa: F401
                         shard_parameters, with_spmd_constraint)
from .trainer import (AdamWState, adamw_update,  # noqa: F401
                      init_adamw_state, make_eval_step, make_train_step)
from . import passes  # noqa: F401
from . import pipeline_spmd  # noqa: F401
from .pipeline import (LayerDesc, PipelineLayer,  # noqa: F401
                       PipelineParallel, SharedLayerDesc, pipeline_apply)
from .pipeline_spmd import pipeline_forward, stack_stage_params  # noqa: F401
from .sequence_parallel import (AllGatherOp, GatherOp,  # noqa: F401
                                ReduceScatterOp, ScatterOp, SegmentParallel,
                                gather_seq,
                                mark_as_sequence_parallel_parameter,
                                sep_attention_context, split_seq,
                                ulysses_alltoall)
from . import ring_attention as ring_attention_mod  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
from . import pipeline_viz  # noqa: F401
from .pipeline_viz import (pipeline_timeline,  # noqa: F401
                           render_timeline, save_chrome_trace,
                           timeline_stats)
