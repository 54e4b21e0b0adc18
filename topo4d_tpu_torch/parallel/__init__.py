"""The all-views batched geometry mode (``parallel/``).

Only the single-device path is ported: views render one after another on
one card. The multi-device mesh and the fused multi-view launch
(``schedule.fuse_views``) are later slices.
"""
