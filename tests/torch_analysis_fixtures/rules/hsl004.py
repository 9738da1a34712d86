"""HSL004 corpus: a kernels.memo key must hash — list, dict and set
displays (or a tuple holding one) flag; the tuple spelling is clean."""

_plans: dict = {}


def memo(table, key, build):
    return table.setdefault(key, build())


def plan_list(n):
    return memo(_plans, [n, 4], lambda: n)  # expect: HSL004


def plan_nested(n):
    return memo(_plans, (n, {"k": 4}), lambda: n)  # expect: HSL004


def plan_keyword(n):
    return memo(_plans, key={n}, build=lambda: n)  # expect: HSL004


def plan_tuple(n):
    return memo(_plans, (n, 4), lambda: n)  # clean
