"""Query language: lexer -> recursive-descent parser -> AST.

Copy of ``neumann_tpu.lang`` (see ``parser.py`` for why it is copied):
SQL + graph + vector (EMBED/SIMILAR with TOP|LIMIT, METRIC, IN
collection, WHERE, CONNECTED TO) + unified + VAULT/CACHE/BLOB/
CHECKPOINT/CHAIN/CLUSTER statements, and Cypher (``cypher.py``). The
port's router executes the SQL, graph, vector, unified and Cypher
statements; VAULT, CACHE, BLOB, CHECKPOINT, CHAIN, CLUSTER and EXPLAIN
parse and are refused at execution.
"""

from neumann_tpu_torch.lang.lexer import Token, tokenize  # noqa: F401
from neumann_tpu_torch.lang.parser import parse, parse_many  # noqa: F401
from neumann_tpu_torch.lang import ast  # noqa: F401
