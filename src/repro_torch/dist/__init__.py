"""Distribution substrate of the port: the fault plane alone.

``fault`` (a copy of ``repro.dist.fault``) holds heartbeat monitoring,
straggler detection and the steal / remesh planning that the serving
cluster (``serve.cluster``) executes.  The reference's other two modules
are not here: ``compression`` (int8 and top-k codecs with error feedback
for slow cross-pod links) is ROADMAP queue 1, item 5, and ``sharding``
(mesh partition rules) has no counterpart on one GPU.
"""

from . import fault
from .fault import (FaultPolicy, HeartbeatMonitor, RemeshPlan, StealPlan,
                    plan_remesh, plan_steal)

__all__ = ["fault", "FaultPolicy", "HeartbeatMonitor", "plan_remesh",
           "plan_steal", "RemeshPlan", "StealPlan"]
