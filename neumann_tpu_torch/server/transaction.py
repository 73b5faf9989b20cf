"""Chain-transaction wrapper for the SDK.

Parity with neumann-py/src/neumann/transaction.py (begin / execute /
commit / rollback with context-manager auto-rollback), issued through
the chain statements the query language actually defines: the
reference SDK sends bare BEGIN/COMMIT that its own parser rejects
(parser.rs parse_begin_chain requires BEGIN CHAIN); here the wrapper
uses BEGIN CHAIN TRANSACTION / COMMIT CHAIN / ROLLBACK CHAIN.

The port's copy of ``neumann_tpu/server/transaction.py``: only its import
lines differ.
"""

from __future__ import annotations

from neumann_tpu_torch.utils.errors import NeumannError


class Transaction:
    """Usage::

        with client.transaction() as tx:
            tx.execute("EMBED STORE 'k' [0.1]")
        # commits on clean exit, rolls back on exception
    """

    def __init__(self, client):
        self._client = client
        self._started = False
        self._committed = False
        self._rolled_back = False

    @property
    def is_active(self) -> bool:
        return (self._started and not self._committed
                and not self._rolled_back)

    def begin(self) -> "Transaction":
        if self._started:
            raise NeumannError("transaction already started")
        self._client.execute("BEGIN CHAIN TRANSACTION")
        self._started = True
        return self

    def execute(self, query: str):
        if not self.is_active:
            raise NeumannError("transaction is not active")
        return self._client.execute(query)

    def commit(self) -> None:
        if not self.is_active:
            raise NeumannError("transaction is not active")
        self._client.execute("COMMIT CHAIN")
        self._committed = True

    def rollback(self) -> None:
        if not self.is_active:
            raise NeumannError("transaction is not active")
        self._client.execute("ROLLBACK CHAIN")
        self._rolled_back = True

    def __enter__(self) -> "Transaction":
        return self.begin()

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.is_active:
            if exc_type is None:
                self.commit()
            else:
                self.rollback()
        return False
