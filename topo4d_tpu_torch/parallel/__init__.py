"""The all-views batched geometry mode and the multi-rank paths
(``parallel/``).

``batched.py``: the batched step, on one card (views one after another, or
all in one fused launch under ``schedule.fuse_views``) or over a view mesh.
``mesh.py``: the view mesh of the ranks, the block of the views each holds,
and the collectives (``all_reduce``, ``broadcast``). ``sharded.py``: the
view-sharded photometric loss. ``multihost.py``: joining the process group
(torchrun's variables or the JAX launch variables) and the host-0 rule.
"""
