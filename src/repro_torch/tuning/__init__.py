"""The tuning subsystem: converge once, persist, reuse forever.

The port of ``repro.tuning``:

* ``space``    — the candidate search space of the measured sweep and
  ``TunedConfig``, the converged artifact;
* ``runner``   — the measured autotune loop on the card: prune with the
  paper's cycle model, time the survivors, attach the f32-vs-bf16 error
  report, persist the winner;
* ``store``    — the persistent on-disk store under
  ``~/.cache/repro-awb-gcn/tuning-torch`` (or ``$REPRO_TORCH_TUNING_STORE``);
* ``registry`` — the in-process caches (fingerprint → schedule / executor),
  keyed by placement (``mesh_fingerprint`` for sharded executors).
"""
from repro_torch.tuning.registry import (  # noqa: F401
    clear_caches,
    executor_for_schedule,
    get_executor,
    get_schedule,
    get_spmm_schedules,
    graph_fingerprint,
    mesh_fingerprint,
)
from repro_torch.tuning.runner import (  # noqa: F401
    autotune,
    autotuned_executor,
    time_call,
    warm_tuned_executor,
)
from repro_torch.tuning.space import (  # noqa: F401
    TunedConfig,
    default_sweep,
    density_matched_k,
    sharded_device_counts,
    sharded_sweep,
)
from repro_torch.tuning.store import TuningStore, mesh_descriptor  # noqa: F401
