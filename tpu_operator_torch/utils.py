"""Own copy of the topology helpers in ``tpu_operator/utils.py``."""


def parse_topology(topology: str) -> tuple[int, ...]:
    """Parse a topology string like ``2x4`` or ``4x4x4`` into dims."""
    try:
        dims = tuple(int(d) for d in topology.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"invalid topology {topology!r}") from e
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"invalid topology {topology!r}")
    return dims


def topology_chips(topology: str) -> int:
    n = 1
    for d in parse_topology(topology):
        n *= d
    return n
