"""Human-readable size parsing ("200M", "4GB") -> bytes (counterpart of
``quiver_tpu/utils/sizes.py``, the reference ``parse_size``)."""

import re

KILO = 1024

UNITS = {
    "KB": KILO,
    "MB": KILO ** 2,
    "GB": KILO ** 3,
    "TB": KILO ** 4,
    "K": KILO,
    "M": KILO ** 2,
    "G": KILO ** 3,
    "T": KILO ** 4,
}

_SIZE_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([A-Za-z]*)\s*$")


def parse_size(size) -> int:
    """Bytes of ``size``: an int or float as it is, or a string such as
    ``"200M"`` or ``"4 GB"`` in binary units."""
    if isinstance(size, (int, float)):
        return int(size)
    if not isinstance(size, str):
        raise ValueError(f"cannot parse size: {size!r}")
    m = _SIZE_RE.match(size)
    if not m:
        raise ValueError(f"cannot parse size: {size!r}")
    value, unit = m.groups()
    if not unit:
        return int(float(value))
    unit = unit.upper()
    if unit not in UNITS:
        raise ValueError(f"unknown size unit {unit!r} in {size!r}")
    return int(float(value) * UNITS[unit])
