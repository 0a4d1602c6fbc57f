"""Retired traversal generations of the JAX package, kept where something
still reads them.

Counterpart of realtimeraytracer_tpu/render/attic/: ``bvh_backend`` is the
lane traversal, the skip-link BVH walk under ``max_traversal_steps``.  As
in the JAX package it is not in ``make_backend``'s registry ("lane"
raises there); the traversal diagnostics (render/diagnostics.py,
``kind="lane"``) call it, and it is the only reader of the BVH's skip
links.  The attic's packet backend is not ported: the JAX package's
``make_backend`` refuses it and nothing of that package runs it.
"""
