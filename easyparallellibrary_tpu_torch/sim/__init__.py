"""Cost-card fleet simulator (port of ``easyparallellibrary_tpu/sim/``).

Discrete-event simulation of the serving fleet at 100–1000-replica
scale: the REAL policy stack (router dispatch/health/failover,
admission ladder, engine autotuner, fleet autoscaler, rollout
controller) runs unmodified over :class:`~easyparallellibrary_tpu_torch.sim.
replica.SimReplica` members whose device step is a calibrated
:class:`~easyparallellibrary_tpu_torch.sim.replica.CostModel` charge on a
virtual clock — policy search in seconds instead of cluster-hours,
with replay fidelity against a recorded real-fleet episode
(``tests/golden/sim_chaos_heal.json``, sim/replay.py).
"""

from easyparallellibrary_tpu_torch.sim.arrivals import (  # noqa: F401
    Workload, make_workload)
from easyparallellibrary_tpu_torch.sim.engine import (  # noqa: F401
    EventQueue, SimClock, XorShift)
from easyparallellibrary_tpu_torch.sim.faults import (  # noqa: F401
    FaultEvent, FaultInjector, death_and_recovery)
from easyparallellibrary_tpu_torch.sim.fleet import (  # noqa: F401
    SimFleet, actuation_sequence)
from easyparallellibrary_tpu_torch.sim.replica import (  # noqa: F401
    CostModel, SimReplica, SimReplicaDead)
