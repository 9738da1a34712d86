"""Index lifecycle states.

Reference parity: actions/Constants.scala:115-129 — 9 states, of which
ACTIVE / DELETED / DOESNOTEXIST are stable; everything else is transient and
blocks further operations until completed or cancelled.
"""

ACTIVE = "ACTIVE"
CREATING = "CREATING"
DELETING = "DELETING"
DELETED = "DELETED"
REFRESHING = "REFRESHING"
VACUUMING = "VACUUMING"
RESTORING = "RESTORING"
DOESNOTEXIST = "DOESNOTEXIST"
OPTIMIZING = "OPTIMIZING"

ALL_STATES = frozenset(
    {ACTIVE, CREATING, DELETING, DELETED, REFRESHING, VACUUMING, RESTORING, DOESNOTEXIST, OPTIMIZING}
)

STABLE_STATES = frozenset({ACTIVE, DELETED, DOESNOTEXIST})
