from .flags import define_flag, flag, get_flags, set_flags  # noqa: F401
