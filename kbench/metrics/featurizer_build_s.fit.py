"""featurizer_build_s.fit: host-clock seconds a fit spends building its
featurizer before ``Pipeline.fit()``: drawing the random weights on the
host, or learning the patch filters and the whitener (the system's build
step, timed by the harness and synchronised with the card)."""


def read(run):
    if not run.fits:
        return None
    return sum(f.build_s for f in run.fits) / len(run.fits)
