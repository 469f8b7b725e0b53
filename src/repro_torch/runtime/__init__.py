"""Runtime of the port: the work journal, the mesh and elastic re-meshing.

    journal   — WorkJournal / PartState: persistent done-flags with the
                paper's backoff-then-help rule (T_avg, Section V-A); the
                serving engine registers every dispatched batch as a part
    sharding  — Mesh / make_mesh / mesh_sig / Sharded / place: named axes
                over device slots (one process drives them all), the
                identity the per-mesh plan caches key on
    elastic   — MeshSpec, plan_mesh_for, plan_serving_mesh,
                ElasticController, StragglerMonitor
"""

from .elastic import (ElasticController, MeshSpec,  # noqa: F401
                      StragglerMonitor, plan_mesh_for, plan_serving_mesh)
from .journal import PartState, WorkJournal  # noqa: F401
from .sharding import Mesh, Sharded, make_mesh, mesh_sig, place  # noqa: F401

__all__ = ["PartState", "WorkJournal", "Mesh", "Sharded", "make_mesh",
           "mesh_sig", "place", "ElasticController", "MeshSpec",
           "StragglerMonitor", "plan_mesh_for", "plan_serving_mesh"]
