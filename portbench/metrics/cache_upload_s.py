"""The device cache's upload seconds (``DeviceResidentLoader.build_seconds
["upload"]``, host clock ending in a device synchronise)."""


def read(summary):
    return summary["cache_upload_s"]
