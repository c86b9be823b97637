from .registry import (ARCH_IDS, PAPER_BUDGETS, PAPER_CONV, PAPER_GEMM,
                       ArchSpec, all_cells, get_arch, get_config, input_specs)

__all__ = [
    "ARCH_IDS", "PAPER_BUDGETS", "PAPER_CONV", "PAPER_GEMM", "ArchSpec",
    "all_cells", "get_arch", "get_config", "input_specs",
]
