"""Port of ``keystone_tpu.pipelines``: end-to-end workloads.

Each module exposes a config dataclass, functions that build its pipelines, and a
``run(config, device=None)`` entry point returning a results dict:
``mnist_random_fft`` (the README's example), ``timit`` (random cosine
features over TIMIT frames, block least squares) and ``text``
(``run_amazon``: n-gram logistic regression on Amazon reviews;
``run_newsgroups``: n-gram naive Bayes on 20 Newsgroups) and ``cifar``
(random-patch convolution features over CIFAR-10 images with block,
rematerializing conv-block, kernel or linear solvers; ``run(config,
variant=...)``).
"""
