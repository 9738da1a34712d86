KNOWN_KERNELS = (
    "ops.good.good",
    "ops.leaky.leaky",
    "ops.fallback.fallback",
)
