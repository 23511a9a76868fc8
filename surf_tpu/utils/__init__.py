from .platform import (  # noqa: F401
    card_name_and_power_limit,
    force_cpu,
    require_gpu,
    use_compile_cache,
)
