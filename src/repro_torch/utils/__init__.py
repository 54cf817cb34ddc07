from repro_torch.utils.registry import Registry
from repro_torch.utils.device import resolve_device
