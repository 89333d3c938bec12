"""Algorithm 1 in PyTorch: topology, consensus backends, the epoch step and
the dynamic-federation layer (schedules, engine, superepoch)."""
from repro_torch.core.consensus import (PushSumState, init_push_sum,
                                        make_backend)
from repro_torch.core.dfl import (DFLConfig, DFLMetrics, DFLState,
                                  build_dfl_epoch_step, carry_forward,
                                  init_dfl_state, masked_server_mean)
from repro_torch.core.engine import DynamicFederationEngine, make_engine
from repro_torch.core.overlap import (EpochScheduleBatch,
                                      build_dfl_superepoch_step,
                                      stack_epoch_schedules)
from repro_torch.core.schedule import (EpochSchedule, FaultEvent,
                                       FaultSchedule, ParticipationSchedule,
                                       SigmaTracker, TopologySchedule,
                                       diurnal_trace,
                                       load_participation_trace,
                                       save_participation_trace)
from repro_torch.core.topology import FLTopology

__all__ = ["DFLConfig", "DFLMetrics", "DFLState", "DynamicFederationEngine",
           "EpochSchedule", "EpochScheduleBatch", "FLTopology", "FaultEvent",
           "FaultSchedule", "ParticipationSchedule", "PushSumState",
           "SigmaTracker", "TopologySchedule", "build_dfl_epoch_step",
           "build_dfl_superepoch_step", "carry_forward", "diurnal_trace",
           "init_dfl_state", "init_push_sum", "load_participation_trace",
           "make_backend", "make_engine", "masked_server_mean",
           "save_participation_trace", "stack_epoch_schedules"]
