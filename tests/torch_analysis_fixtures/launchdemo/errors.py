class HyperspaceError(Exception):
    """The fixture's typed framework error."""
