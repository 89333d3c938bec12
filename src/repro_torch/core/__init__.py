"""Algorithm 1 in PyTorch: topology, consensus backends and the epoch step."""
from repro_torch.core.consensus import make_backend
from repro_torch.core.dfl import (DFLConfig, DFLMetrics, DFLState,
                                  build_dfl_epoch_step, init_dfl_state)
from repro_torch.core.schedule import SigmaTracker
from repro_torch.core.topology import FLTopology

__all__ = ["DFLConfig", "DFLMetrics", "DFLState", "FLTopology",
           "SigmaTracker", "build_dfl_epoch_step", "init_dfl_state",
           "make_backend"]
