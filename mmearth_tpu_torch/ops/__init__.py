"""The hand-written kernels' wrappers.  Each counts the launches it enqueues
(or that a CUDA graph capture records) in its module's ``LAUNCHES``."""


def launch_counts() -> dict[str, int]:
    """Every wrapper's launch count, by key."""
    from . import dwconv, fused_block, patch_select, wholeblock

    return {key: n for counts in (patch_select.LAUNCHES, wholeblock.LAUNCHES,
                                  fused_block.LAUNCHES, dwconv.LAUNCHES)
            for key, n in counts.items()}
