"""Own copy of the topology helpers in ``tpu_operator/utils.py`` and of
``hashed_name`` from ``tpu_operator/state/nodepool.py``."""

FNV1A_64_OFFSET = 0xCBF29CE484222325
FNV1A_64_PRIME = 0x100000001B3


def fnv1a_64(data: bytes) -> int:
    h = FNV1A_64_OFFSET
    for b in data:
        h ^= b
        h = (h * FNV1A_64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def hashed_name(base: str, suffix: str, cap: int = 63) -> str:
    """``<base>-<suffix>``, cut to a DNS-1123 name of at most ``cap``
    characters with an FNV-1a digest of the whole when it is longer: the
    reference's rule, so both packages name the same objects."""
    name = f"{base}-{suffix}"
    if len(name) <= cap:
        return name
    digest = format(fnv1a_64(name.encode()) & 0xFFFFFFFF, "08x")
    return f"{name[: cap - 9]}-{digest}"


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
