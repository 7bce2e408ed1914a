"""PyTorch/CUDA port of ``ruleset_analysis_tpu``.

The same question with the same answer — which ASA ACL rules syslog
traffic hits, by whom, and which rules are dead — computed with PyTorch
on an NVIDIA GPU.  The JAX package beside this one is the reference: the
port's registers and reports are held against it bit for bit.  Each of
its two Pallas kernels is a hand-written CUDA kernel here
(``csrc/first_match.cu``, ``csrc/match_hist.cu``).

The package imports ``torch`` and ``numpy``, never ``jax``, and nothing
of ``ruleset_analysis_tpu``: the JAX-free host modules it needs are its
own copies.
"""

#: the reference's version, which the port's reports and formats follow
__version__ = "0.1.0"
