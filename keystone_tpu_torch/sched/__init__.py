"""Cost-governed co-scheduling on one card: background work (refit folds,
tune probes, finish solves) admitted into serving idle gaps, priced from
the cost observatory (``obs/cost.py``) and preempted at chunk boundaries
through the durable fold (``reliability/durable.py``). Port of
``keystone_tpu/sched/``; imports no torch at import time.
:mod:`.demo` is the co-scheduled serve + refit demo."""

from .pricing import (  # noqa: F401
    LeasePrice,
    choose_chunk_rows,
    gram_stream_facts,
    price_stream_fold,
)
from .scheduler import (  # noqa: F401
    Lease,
    LeaseRequest,
    MeshScheduler,
    get_scheduler,
    maybe_lease,
    pressure_aware_interval,
    set_scheduler,
)
