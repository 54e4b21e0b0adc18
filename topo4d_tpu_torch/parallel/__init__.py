"""The all-views batched geometry mode (``parallel/``).

Only the single-device path is ported: views render one after another on
one card, or all in one fused launch (``schedule.fuse_views``). The
multi-device mesh is a later slice.
"""
