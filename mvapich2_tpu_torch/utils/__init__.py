import torch


def is_device_tensor(buf) -> bool:
    """True for a ``torch.Tensor``: the port's counterpart of the JAX
    package's ``is_device_array``. A tensor is routed as device-resident
    whatever its device; a numpy buffer is a host buffer."""
    return isinstance(buf, torch.Tensor)
