KNOWN_COUNTERS = ("plans.built",)


def increment(name):
    return name
