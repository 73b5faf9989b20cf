"""Docs dogfooding CLI (neumann_docs parity).

Indexes a directory of markdown/text files into all three engines — one
entity per section with a feature-hash embedding, graph edges between a
file and its sections, a relational table of sections — then answers
searches with the hybrid engine. Run:

    python -m neumann_tpu_torch.docs_cli index docs/
    python -m neumann_tpu_torch.docs_cli search "how does the wal recover"

The port's copy of ``neumann_tpu/docs_cli.py``. Besides the import
lines, ``main`` takes a ``router``: it builds the port's ``QueryRouter()``
on the card unless the caller passes one of its own (for example
``QueryRouter(device="cpu")``), as the shell does.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

from neumann_tpu_torch.cache.llm_cache import default_embedder
from neumann_tpu_torch.engines.relational import Column
from neumann_tpu_torch.router import QueryRouter

_DIM = 256
_STATE = os.path.join(os.path.expanduser("~"), ".neumann_tpu_docs.ntpu")


def _sections(path: str) -> List[Tuple[str, str]]:
    """(title, body) pairs split on markdown headings."""
    with open(path, encoding="utf-8", errors="replace") as fh:
        text = fh.read()
    out: List[Tuple[str, str]] = []
    title = os.path.basename(path)
    buf: List[str] = []
    for line in text.splitlines():
        if line.startswith("#"):
            if buf:
                out.append((title, "\n".join(buf)))
            title = line.lstrip("# ").strip() or title
            buf = []
        else:
            buf.append(line)
    if buf:
        out.append((title, "\n".join(buf)))
    return [(t, b) for t, b in out if b.strip()]


def build_index(router: QueryRouter, directory: str) -> int:
    if not router.relational.table_exists("doc_sections"):
        router.relational.create_table("doc_sections", [
            Column("file", "text"), Column("title", "text"),
            Column("chars", "int")])
    count = 0
    for root, _, files in os.walk(directory):
        for fname in sorted(files):
            if not fname.endswith((".md", ".txt", ".rst")):
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, directory)
            file_key = f"file:{rel}"
            router.unified.create_entity(file_key, {"kind": "file"})
            for i, (title, body) in enumerate(_sections(path)):
                key = f"sec:{rel}#{i}"
                emb = default_embedder(f"{title} {body}", _DIM)
                router.unified.create_entity(
                    key, {"kind": "section", "title": title,
                          "file": rel}, embedding=emb)
                router.unified.connect_entities(file_key, key,
                                                "contains")
                router.relational.insert("doc_sections", {
                    "file": rel, "title": title, "chars": len(body)})
                count += 1
    return count


def search(router: QueryRouter, query: str, k: int = 5) -> List[dict]:
    emb = default_embedder(query, _DIM)
    hits = router.unified.find_similar_entities(emb, k)
    out = []
    for h in hits:
        ent = router.unified.get_entity(h.key)
        if ent and ent["fields"].get("kind") == "section":
            out.append({"key": h.key, "score": round(h.score, 4),
                        "title": ent["fields"].get("title"),
                        "file": ent["fields"].get("file")})
    return out


def main(argv=None, router: Optional[QueryRouter] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in ("index", "search"):
        print(__doc__)
        return 2
    router = router if router is not None else QueryRouter()
    if argv[0] == "index":
        directory = argv[1] if len(argv) > 1 else "docs"
        n = build_index(router, directory)
        router.store.save_snapshot(_STATE)
        print(f"indexed {n} sections from {directory} -> {_STATE}")
        return 0
    if not os.path.exists(_STATE):
        print("no index yet — run `index <dir>` first")
        return 1
    router.store.load_snapshot(_STATE)
    for hit in search(router, " ".join(argv[1:])):
        print(f"{hit['score']:>7}  {hit['file']}  §{hit['title']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
