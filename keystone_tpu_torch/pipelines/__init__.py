"""Port of ``keystone_tpu.pipelines``: end-to-end workloads.

Each module exposes a config dataclass, ``build_pipeline`` builders and a
``run(config, device=None)`` entry point returning a results dict.
"""
