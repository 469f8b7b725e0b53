"""Data substrate: series generators (FreSh) and the token pipeline."""

from .synthetic import query_workload, random_walk  # noqa: F401
from .tokens import TokenPipeline  # noqa: F401
