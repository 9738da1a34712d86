"""Re-export of the lifecycle state constants.

The constants live in `hyperspace_tpu_torch.states` (a leaf module) so that
the metadata plane can import them without pulling in the actions package —
mirrors actions/Constants.scala:115-129 in the reference.
"""

from hyperspace_tpu_torch.states import (  # noqa: F401
    ACTIVE,
    ALL_STATES,
    CREATING,
    DELETED,
    DELETING,
    DOESNOTEXIST,
    OPTIMIZING,
    REFRESHING,
    RESTORING,
    STABLE_STATES,
    VACUUMING,
)
