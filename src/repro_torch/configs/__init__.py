from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable_cells, input_specs  # noqa: F401
