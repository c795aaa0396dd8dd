from . import hashing_utils, json_utils, path_utils, resolver_utils  # noqa: F401
