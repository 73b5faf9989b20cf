"""Query router: parse + dispatch to the port's engines."""

from neumann_tpu_torch.router.router import QueryResult, QueryRouter  # noqa: F401
