"""Mean bytes of dense transform operators a read call put on its device,
in MB: the program's ``transform.ops_bytes`` counter, which the traffic
kind records per call. None where no call recorded it (a program without
the counter)."""


def read(trace):
    xs = [c["counters"]["transform.ops_bytes"] for c in trace.of_kind("read")
          if "transform.ops_bytes" in c.get("counters", {})]
    return sum(xs) / len(xs) / 1e6 if xs else None
