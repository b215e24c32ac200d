"""Device kernels grouped by what they do: a frozen copy of the program's
kernel-name table (``mmearth_tpu_torch/utils/profiling.py::GROUPS``), so that
the benchmark's breakdown does not move when the program's table does.
Each entry is a fragment, or a tuple of fragments that must all appear,
case-insensitively; the first match wins."""

# kernel-name fragments (a tuple: all of them) -> group, first match wins
GROUPS = (
    ("dw7_wgrad", "dense dwconv dW (port kernel)"),
    (("fwd_stat_kernel", "SpillRows"), "spill-g fwd A (port kernel)"),  # row 7
    ("spillg_fwd_a", "spill-g fwd A (port kernel)"),  # row 7's earlier kernel
    ("spillg_fwd_b", "spill-g fwd B (port kernel)"),  # row 8
    ("spillg_bwd", "spill-g bwd C/D row passes (port kernels)"),
    ("SpillRows", "spill-g bwd C/D row passes (port kernels)"),  # D: bwd_dv_kernel<..., SpillRows>
    ("fwd_stat_kernel", "masked-dense fwd stat/apply (port kernels)"),  # <..., KeptRows>
    ("masked_fwd", "masked-dense fwd stat/apply (port kernels)"),
    ("masked_bwd", "masked-dense bwd stat/dv row passes (port kernels)"),
    ("KeptRows", "masked-dense bwd stat/dv row passes (port kernels)"),
    ("spillg_atb", "dW1/dW2 X^T Y passes (port kernel)"),
    ("dw7_fwd", "dwconv7_gathered fwd (port kernel)"),
    ("dw7_bwd", "dwconv7_gathered bwd (port kernel)"),
    ("patch_copy", "patch gather/scatter (port kernel)"),  # rows 1-2: patch_copy_bulk/_reg
    ("gather_kernel", "patch gather/scatter (port kernel)"),  # their earlier kernels
    ("scatter_kernel", "patch gather/scatter (port kernel)"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("gemm", "matmul (cuBLAS)"),
    ("xmma", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("conv", "convolution (cuDNN)"),
    ("cudnn", "convolution (cuDNN)"),
    ("reduce", "reductions"),
    ("Memcpy", "memcpy"),
    ("Memset", "memset"),
    ("elementwise", "elementwise"),
    ("index", "indexing"),
    ("gather", "indexing"),
    ("scatter", "indexing"),
)


def matches(name: str, frags) -> bool:
    low = name.lower()
    return all(f.lower() in low for f in ((frags,) if isinstance(frags, str) else frags))


def group_of(name: str) -> str:
    for frags, group in GROUPS:
        if matches(name, frags):
            return group
    return "other"
