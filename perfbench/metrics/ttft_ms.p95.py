"""95th percentile over the window's completed requests of the time from
the client's send to the end of that prompt's prefill (its first token
sampled and on the host): the front end, the dispatcher queue and
admission, and the prefill. Traced runs only."""
from perfbench.record import percentile


def read(rec):
    xs = [(d.t_first - d.t_send) * 1e3 for d in rec.done
          if d.ok and d.t_first is not None]
    return percentile(xs, 95)
