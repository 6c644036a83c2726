import torch


def is_device_tensor(buf) -> bool:
    """True for a ``torch.Tensor``: the port's counterpart of the JAX
    package's ``is_device_array``. A tensor is routed as device-resident
    whatever its device; a numpy buffer is a host buffer."""
    return isinstance(buf, torch.Tensor)


def on_card(buf) -> bool:
    """True for a tensor that does not lie on the CPU. The host tier
    never takes one: a call that the device tier cannot run raises for
    it instead of moving the tensor to the host and back."""
    return isinstance(buf, torch.Tensor) and buf.device.type != "cpu"
