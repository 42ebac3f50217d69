"""pscheck for the port: project lint rules + concurrency sanitizer.

Static half (``python -m repro_torch.analysis.check``, stdlib ``ast``
only; default paths ``src/repro_torch``, ``chip_smoke.py`` and
``examples/torch_port``):

====== ==============================================================
rule   invariant
====== ==============================================================
PS101  pin/unpin balance: pin-acquiring functions must release on
       every exit path (try/except/finally) or be pragma'd as
       ownership-transferring
PS201  lock discipline: lock nesting (``with self._lock``, and a
       module lock's ``with _lock``) must follow the declared order
       table (``repro_torch.analysis.locks.LOCK_ORDER``)
PS202  no blocking call (cluster.pull, NetworkModel.transfer, file
       I/O, sleep/join/wait) while holding a lock whose spec says
       ``blocking_ok=False``
PS301  no silent degradation: broad ``except`` must re-raise, use the
       bound exception, or count/log — never swallow NodeDownError /
       SSDCorruptionError
PS302  no fallback that hides the device or the kernel: a function
       that launches a kernel (a ``*_cuda`` wrapper or
       ``build.library``) must not return a ``*_plain``/``*_ref``
       call from a branch on shape or dtype, or from an ``except``
       around the launch; dispatch on the device (``is_cuda``,
       ``is_meta``, ``device``) or a variant chooser
       (``flash_variant``, ``gmm_variant``, ``topk_plan``) is explicit
PS401  counter hygiene: ``Counters.inc`` / ctor names must come from
       ``repro_torch.metrics.KNOWN_COUNTERS``
PS501  no ``F.one_hot`` / ``F.embedding`` / ``torch.take`` /
       ``index_select`` on a parameter table in production forwards
       under ``models/``: embedding gathers go through ``kernels.ops``
PS502  the launch contract: every ctypes ``lib.<kernel>_launch(...)``
       has its return code bound and raised on when nonzero, and is
       passed PyTorch's current stream
====== ==============================================================

Suppression: append ``# pscheck: ok PSxxx <reason>`` to the finding's
line (or the enclosing ``def`` line), or add ``PSxxx path::qualname``
to ``pscheck_torch_baseline.txt`` for grandfathered cases.

Runtime half (``repro_torch.analysis.sanlock``, enabled by
``REPRO_TORCH_SANLOCK=1`` through ``repro_torch.analysis.pytest_plugin``):
wraps ``threading.Lock``/``RLock`` allocated inside ``src/repro_torch``,
records the actual lock-acquisition graph, fails a test whose graph has a
cycle, and asserts ``Cluster.total_pins() == 0`` at teardown.
"""

from repro_torch.analysis.rules import Finding, run_rules  # noqa: F401
