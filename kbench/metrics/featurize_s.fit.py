"""featurize_s.fit: device seconds a fit spends in the featurizer, from
the kernels launched inside the harness's ranges around the entry points
the configuration lists under ``layer_calls.featurize`` (the cosine
branches and their concatenation; the convolutional featurizer's patch
rows, statistics and pooled blocks)."""


def read(run):
    if run.trace is None or not run.fits or "featurize" not in run.trace.layer_s:
        return None
    return run.trace.layer_s["featurize"] / len(run.fits)
