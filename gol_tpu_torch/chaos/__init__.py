"""Network fault injection: the adversarial half of the fleet's story.

Without it, every failure the fleet is tested against is one a test
process chooses to inject at the disk or process level (``resilience/faults.py``: torn
payload writes, SIGKILL at checkpoint boundaries). The network path between
client, router, and workers — the hops real deployments lose first — is
exercised here:

- ``chaos/plan.py``  — a declarative, SEEDED fault schedule (``ChaosPlan``)
  in the same ``k=v,k=v`` grammar as ``resilience/faults.FaultPlan``: added latency,
  connection refusal/reset mid-exchange, slow-loris reads, truncated
  responses, and bit-flipped payload bytes, each with its own probability.
- ``chaos/proxy.py`` — a torch-free in-process HTTP-aware proxy
  (``ChaosProxy``/``ProxyPool``) that fronts any worker or router socket
  and injects the plan's faults per exchange. Mountable under
  ``gol fleet --chaos PLAN`` (the router's data path to its workers) and
  programmatically in tests and the chaos bench lane.

The package is stdlib-only (the router imports it; the router owns no
device) and perf_counter-only (the fleet's wall-clock ban extends here). Production fleets without ``--chaos`` never import a proxy and
route exactly as before.
"""

from gol_tpu_torch.chaos.plan import ChaosPlan, ChaosSchedule
from gol_tpu_torch.chaos.proxy import ChaosProxy, ProxyPool

__all__ = ["ChaosPlan", "ChaosProxy", "ChaosSchedule", "ProxyPool"]
