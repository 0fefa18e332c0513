"""Mean passes the slice route's doubling scans made over their boxes in a
write call (compress): the program's ``transform.scan_passes`` counter
(2 ceil(log2 n) a Thomas solve over n coarse nodes), which the traffic kind
records per call. None where no call recorded it (a program without the
counter)."""


def read(trace):
    xs = [c["counters"]["transform.scan_passes"]
          for c in trace.of_kind("write")
          if "transform.scan_passes" in c.get("counters", {})]
    return sum(xs) / len(xs) if xs else None
