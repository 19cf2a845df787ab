from .device_cache import DeviceResidentLoader  # noqa: F401
