"""serve.copy_pct: device→host copies' time as a share of the device's busy
time in the traced window, in %."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    copies = sum(d.end - d.start for d in tr.device
                 if d.cat == "gpu_memcpy" and "DtoH" in d.name) / 1e6
    busy = tr.busy_s()
    return 100.0 * copies / busy if busy > 0 and copies > 0 else None
