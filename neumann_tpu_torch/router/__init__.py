"""Query router: parse + dispatch for the vector statements."""

from neumann_tpu_torch.router.router import QueryResult, QueryRouter  # noqa: F401
