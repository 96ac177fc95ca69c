"""Host seconds of the program's scene preparation (prepare, and on a
mesh prepare_sharded), by the harness's clock ended by a device sync."""


def read(s):
    return s.get("prepare_s")
