"""PyTorch/CUDA port of the H2EAL serving system.

The lockstep serving path (prefill, hybrid sparse decode, greedy
generation) for dense GQA models, with hand-written Hopper kernels for
prefill attention, page scoring and decode attention. Module names mirror
the JAX package ``repro`` so each counterpart is easy to find; nothing here
imports JAX or that package.
"""
