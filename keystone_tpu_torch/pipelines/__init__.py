"""Port of ``keystone_tpu.pipelines``: end-to-end workloads.

Each module exposes a config dataclass, ``build_pipeline`` builders and a
``run(config, device=None)`` entry point returning a results dict:
``mnist_random_fft`` (the README's example) and ``timit`` (random cosine
features over TIMIT frames, block least squares).
"""
