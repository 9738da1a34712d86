"""HSL026 launch-contract corpus. KNOWN_KERNELS and SOURCES must agree
both ways with the counted wrappers and their load() engagements, and
each wrapper's closure must prove (a) its plain version only on the CPU
branch, (b) count_launch(wrapper), (c) a raise on a non-zero CUDA status,
(d) no fallback."""

LAUNCH_SANCTIONED = {
    "hsl026.count_launch": "the launch count",
    "hsl026.load": "the kernel library",
}

KNOWN_KERNELS = ("good", "noplain", "fallback", "nostatus", "stale")  # expect: HSL026

SOURCES = {  # expect: HSL026
    "good": "good.cu",
    "noplain": "noplain.cu",
    "fallback": "fallback.cu",
    "nostatus": "nostatus.cu",
    "undeclared": "undeclared.cu",
    "orphan": "orphan.cu",
}


class HyperspaceError(Exception):
    pass


def count_launch(wrapper):
    wrapper.launches += 1


def load(name):
    return None


def good(x):
    if not x.is_cuda:
        return good_plain(x)
    err = load("good").hs_good(x.data_ptr())
    if err != 0:
        raise HyperspaceError(f"good failed: {err}")
    count_launch(good)  # clean: all four proven
    return x


def good_plain(x):
    return x


def noplain(x):
    err = load("noplain").hs_noplain(x.data_ptr())
    if err != 0:
        raise HyperspaceError(f"noplain failed: {err}")
    count_launch(noplain)  # expect: HSL026
    return x


def noplain_plain(x):
    return x


def fallback(x):
    if not x.is_cuda:
        return fallback_plain(x)
    try:
        err = load("fallback").hs_fallback(x.data_ptr())
        if err != 0:
            raise HyperspaceError(f"fallback failed: {err}")
    except HyperspaceError:
        return fallback_plain(x)
    count_launch(fallback)  # expect: HSL026
    return x


def fallback_plain(x):
    return x


def nostatus(x):
    if x.device.type == "cpu":
        return nostatus_plain(x)
    load("nostatus").hs_nostatus(x.data_ptr())
    count_launch(nostatus)  # expect: HSL026
    return x


def nostatus_plain(x):
    return x


def undeclared(x):
    if not x.is_cuda:
        return undeclared_plain(x)
    err = load("undeclared").hs_undeclared(x.data_ptr())
    if err:
        raise HyperspaceError(f"undeclared failed: {err}")
    count_launch(undeclared)  # expect: HSL026
    return x


def undeclared_plain(x):
    return x


for _w in (good, noplain, fallback, nostatus, undeclared):
    _w.launches = 0
