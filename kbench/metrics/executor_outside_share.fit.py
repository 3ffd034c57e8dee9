"""executor_outside_share.fit: the share of fit wall time spent outside
every pipeline node and outside the featurizer's build: planning, the
optimizer, the plan-time verifier and host work between nodes. Node
seconds come from ``workflow/tracing.py::trace()`` (each node forced and
synchronised with the card). In %."""


def read(run):
    fits = [f for f in run.fits if f.node_s is not None]
    wall = sum(f.wall_s for f in fits)
    if not fits or wall <= 0:
        return None
    return 100.0 * sum(f.wall_s - f.node_s - f.build_s for f in fits) / wall
