"""Themed per-result-type output formatting for the shell.

Capability parity with the reference shell's output module
(neumann_shell/src/output/{mod,rows,table,vector,graph}.rs + src/style.rs):
each QueryResult kind gets its own styled renderer — unicode box tables
with colored headers for rows, score bars for SIMILAR hits, arrow chains
for paths, icons for nodes/edges — selected by a Theme. The "plain"
theme (ASCII, no ANSI) is the non-TTY default so piped output and tests
stay byte-stable.

The port's copy of ``neumann_tpu/shell/output.py``, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

__all__ = ["Theme", "THEMES", "TableBuilder", "format_result",
           "detect_theme"]


@dataclass(frozen=True)
class Theme:
    name: str
    unicode: bool            # box-drawing borders + icons
    color: bool              # ANSI escapes
    header: str = ""
    border: str = ""
    key: str = ""
    num: str = ""
    null: str = ""
    ok: str = ""
    err: str = ""
    bar_hi: str = ""
    bar_lo: str = ""
    dim: str = ""
    reset: str = ""

    def c(self, code: str, text: str) -> str:
        return f"{code}{text}{self.reset}" if self.color and code \
            else text

    @property
    def icon_ok(self) -> str:
        return "✓" if self.unicode else "OK"

    @property
    def icon_node(self) -> str:
        return "●" if self.unicode else "*"

    @property
    def icon_edge(self) -> str:
        return "→" if self.unicode else "->"


THEMES: Dict[str, Theme] = {
    "plain": Theme("plain", unicode=False, color=False),
    # the reference ships dark/light/minimal themes (src/style.rs);
    # same split here, colors chosen for dark/light terminal bg
    "dark": Theme("dark", unicode=True, color=True,
                  header="\033[1;36m", border="\033[38;5;240m",
                  key="\033[33m", num="\033[35m", null="\033[2m",
                  ok="\033[32m", err="\033[31m",
                  bar_hi="\033[32m", bar_lo="\033[38;5;240m",
                  dim="\033[2m", reset="\033[0m"),
    "light": Theme("light", unicode=True, color=True,
                   header="\033[1;34m", border="\033[38;5;250m",
                   key="\033[31m", num="\033[35m", null="\033[2m",
                   ok="\033[32m", err="\033[31m",
                   bar_hi="\033[34m", bar_lo="\033[38;5;250m",
                   dim="\033[2m", reset="\033[0m"),
    "minimal": Theme("minimal", unicode=True, color=False),
}


def detect_theme(stream=None) -> Theme:
    isatty = getattr(stream, "isatty", lambda: False)
    return THEMES["dark"] if isatty() else THEMES["plain"]


def _fmt_value(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, bytes):
        return f"<{len(v)} bytes>"
    s = str(v)
    return s if len(s) <= 60 else s[:57] + "..."


class TableBuilder:
    """Box table with per-theme borders and colored header
    (reference: output/table.rs TableBuilder)."""

    def __init__(self, theme: Theme):
        self.theme = theme
        self.cols: List[str] = []
        self.rows: List[Dict[str, str]] = []
        self._color: List[Dict[str, str]] = []   # per-cell ANSI code

    def add_row(self, row: dict,
                colors: Optional[Dict[str, str]] = None) -> None:
        for k in row:
            if k not in self.cols:
                self.cols.append(k)
        self.rows.append({k: _fmt_value(v) for k, v in row.items()})
        self._color.append(colors or {})

    def build(self) -> str:
        t = self.theme
        if not self.rows:
            return "(no rows)"
        widths = {c: len(c) for c in self.cols}
        for r in self.rows:
            for c in self.cols:
                widths[c] = max(widths[c], len(r.get(c, "")))
        if t.unicode:
            tl, tm, tr, ml, mm, mr, bl, bm, br, h, v = \
                "┌", "┬", "┐", "├", "┼", "┤", "└", "┴", "┘", "─", "│"
        else:
            tl = tm = tr = ml = mm = mr = bl = bm = br = "+"
            h, v = "-", "|"

        def rule(lft, mid, rgt):
            line = lft + mid.join(h * (widths[c] + 2)
                                  for c in self.cols) + rgt
            return t.c(t.border, line)

        bv = t.c(t.border, v)
        out = [rule(tl, tm, tr)]
        out.append(bv + bv.join(
            f" {t.c(t.header, c.ljust(widths[c]))} "
            for c in self.cols) + bv)
        out.append(rule(ml, mm, mr))
        for r, cc in zip(self.rows, self._color):
            cells = []
            for c in self.cols:
                val = r.get(c, "")
                code = cc.get(c, t.null if val == "NULL" else "")
                cells.append(f" {t.c(code, val.ljust(widths[c]))} ")
            out.append(bv + bv.join(cells) + bv)
        out.append(rule(bl, bm, br))
        return "\n".join(out)


def format_rows(rows: List[dict], theme: Theme) -> str:
    tb = TableBuilder(theme)
    for row in rows:
        tb.add_row(row)
    n = len(rows)
    return f"{tb.build()}\n{theme.c(theme.dim, f'({n} row(s))')}"


def _score_bar(score: float, lo: float, hi: float, theme: Theme) -> str:
    """8-cell score bar like the reference's SIMILAR meter
    (output/vector.rs); filled cells scale within the result page."""
    span = (hi - lo) or 1.0
    frac = min(max((score - lo) / span, 0.0), 1.0)
    filled = round(frac * 8)
    if theme.unicode:
        bar = "▰" * filled + "▱" * (8 - filled)
    else:
        bar = "#" * filled + "." * (8 - filled)
    return (theme.c(theme.bar_hi, bar[:filled])
            + theme.c(theme.bar_lo, bar[filled:])) \
        if theme.color else bar


def format_similar(results: List[dict], theme: Theme) -> str:
    if not results:
        return "(no hits)"
    scores = [r.get("score") for r in results
              if isinstance(r.get("score"), (int, float))]
    lo = min(scores) if scores else 0.0
    hi = max(scores) if scores else 1.0
    tb = TableBuilder(theme)
    for r in results:
        row = dict(r)
        sc = row.get("score")
        if isinstance(sc, (int, float)):
            row["score"] = f"{sc:.6f}"
            row[""] = _score_bar(float(sc), lo, hi, theme)
        tb.add_row(row, colors={"key": theme.key, "score": theme.num})
    n = len(results)
    return f"{tb.build()}\n{theme.c(theme.dim, f'({n} hit(s))')}"


def _looks_like_path(v) -> bool:
    return (isinstance(v, dict) and isinstance(v.get("path"), list)
            and all(isinstance(x, str) for x in v["path"]))


def format_path(v: dict, theme: Theme) -> str:
    arrow = f" {theme.icon_edge} "
    chain = arrow.join(theme.c(theme.key, x) for x in v["path"])
    cost = v.get("cost")
    tail = f"  {theme.c(theme.dim, f'(cost {cost:.6g})')}" \
        if isinstance(cost, (int, float)) else ""
    return f"{chain}{tail}"


def _graphish(rows: Sequence[dict]) -> bool:
    if not rows:
        return False
    keys = set(rows[0])
    return {"src", "dst"} <= keys or {"from", "to"} <= keys


def format_edges(rows: List[dict], theme: Theme) -> str:
    lines = []
    for r in rows:
        a = r.get("src", r.get("from"))
        b = r.get("dst", r.get("to"))
        label = r.get("label") or r.get("edge") or ""
        mid = f"-[{label}]{theme.icon_edge}" if label else \
            f" {theme.icon_edge} "
        extra = {k: v for k, v in r.items()
                 if k not in ("src", "dst", "from", "to", "label",
                              "edge")}
        tail = f"  {theme.c(theme.dim, _fmt_value(extra))}" if extra \
            else ""
        lines.append(f"{theme.icon_node} {theme.c(theme.key, str(a))} "
                     f"{mid} {theme.c(theme.key, str(b))}{tail}")
    n = len(rows)
    return "\n".join(lines) + \
        f"\n{theme.c(theme.dim, f'({n} edge(s))')}"


def format_result(res, theme: Theme) -> str:
    """Render a router QueryResult under ``theme`` (dispatch parity
    with output/mod.rs format_result)."""
    if res.kind == "rows":
        if _graphish(res.rows) and theme.unicode:
            return format_edges(res.rows, theme)
        return format_rows(res.rows, theme)
    if res.kind == "similar":
        return format_similar(res.results, theme)
    if res.kind == "count":
        if res.message:
            return theme.c(theme.ok, f"{theme.icon_ok} ") + res.message \
                if theme.unicode else res.message
        return str(res.count)
    if res.kind == "value":
        if res.message:
            return res.message
        if _looks_like_path(res.value):
            return format_path(res.value, theme)
        return _fmt_value(res.value)
    if theme.unicode and res.message:
        return f"{theme.c(theme.ok, theme.icon_ok)} {res.message}"
    return res.message
