"""The venue choice of every operator that has one.

Operators whose output must land on the host (a materialized join's match
pairs, a build's row permutation, a filter's mask) can also run on the
host: numpy and the native C++ library over host copies of the columns.
`pick_venue` makes that choice for every operator with a venue (join
merge, build sort, aggregation reduce, ORDER BY, predicate masks).

A port of the JAX package's `parallel/bandwidth.py`, with the same
precedence and messages for a forced venue, and one deliberate
difference: `auto` is always the device venue, and the port measures no
link. The JAX package's `auto` takes the host below a measured
card→host link floor (`hyperspace.join.venueMinMbps`), because its
columns start on the host and the host venue saves link traffic. The
port's columns are uploaded to the session's device when they are read,
so its host venue downloads them again and uploads its result: on a slow
link it would add link traffic, not save it. The host venue runs only
where a venue key or HYPERSPACE_VENUE forces it, and
`hyperspace.join.venueMinMbps` is accepted and read by nothing.
"""

from __future__ import annotations

import os

from hyperspace_tpu_torch.exceptions import HyperspaceError


def pick_venue(requested: str, what: str, needs_native: bool = True) -> str:
    """Shared auto/device/host venue selection.

    `requested` other than auto forces the venue: forcing "host" without
    the native library (where the host path needs it) is an error, never a
    silent device retreat. `needs_native=False` marks host paths written
    in numpy alone. `auto` is the device.

    The HYPERSPACE_VENUE environment variable overrides every auto
    decision at once (an explicit per-operator setting still wins): the
    testing and operations switch for one venue across a whole run."""
    from hyperspace_tpu_torch import native

    forced_by_env = False
    if requested == "auto":
        env = os.environ.get("HYPERSPACE_VENUE", "")
        if env:
            if env not in ("device", "host"):
                raise HyperspaceError(f"unknown HYPERSPACE_VENUE={env!r} (device|host)")
            requested = env
            forced_by_env = True

    if requested == "host":
        if needs_native and not native.available():
            origin = "HYPERSPACE_VENUE" if forced_by_env else what
            raise HyperspaceError(
                f"{origin}=host requires the native library (g++ build failed "
                "or unavailable); use auto or device"
            )
        return "host"
    if requested in ("device", "auto"):
        return "device"
    raise HyperspaceError(f"unknown {what}={requested!r} (auto|device|host)")
