"""deeplearning4j_tpu_torch.chaos: deterministic fault injection and
the shared retry policy (counterpart of ``deeplearning4j_tpu/chaos``).

Named injection sites are threaded through the port's checkpointing
(``checkpoint.write`` / ``checkpoint.read``), data path
(``data.fetch``), serving backends (``serving.worker.step``,
``serving.kv.migrate``) and the fleet (``serving.replica``,
``serving.replica.boot``); a seed-driven process-wide injector
(``chaos.install(plan, seed=...)``) fires declaratively planned faults
at them, replayably. The plan schema and site table are the JAX
package's, so a plan it accepts is accepted here and the same ``(plan,
seed)`` gives the same fault schedule. ``chaos.netproxy`` is the
network chaos proxy the fleet boots replicas behind.

Stdlib-only on import (counters and the flight recorder are reached
lazily, only when a fault fires).
"""

from deeplearning4j_tpu_torch.chaos.injector import (  # noqa: F401
    ChaosError, ChaosIOError, ChaosOSError, Fault, FaultInjector,
    FaultPlan, FaultSpec, SITES, SimulatedCrashError, current,
    file_fault, hit, install, parse_plan, step_fault, uninstall,
)
from deeplearning4j_tpu_torch.chaos.netproxy import (  # noqa: F401
    NET_KINDS, NET_SITES, NetChaosProxy, NetFault, NetSpec,
    NetworkPlan, parse_net_plan,
)
from deeplearning4j_tpu_torch.chaos.retry import (  # noqa: F401
    DEFAULT_IO_RETRY, RetryPolicy, retrying_io,
)

__all__ = ["ChaosError", "ChaosIOError", "ChaosOSError", "Fault",
           "FaultInjector", "FaultPlan", "FaultSpec", "SITES",
           "SimulatedCrashError", "current", "file_fault", "hit",
           "install", "parse_plan", "step_fault", "uninstall",
           "NET_KINDS", "NET_SITES", "NetChaosProxy", "NetFault",
           "NetSpec", "NetworkPlan", "parse_net_plan",
           "DEFAULT_IO_RETRY", "RetryPolicy", "retrying_io"]
