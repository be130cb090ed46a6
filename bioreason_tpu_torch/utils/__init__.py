from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype

__all__ = ["resolve_device", "torch_dtype"]
