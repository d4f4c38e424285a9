"""The phase probe's source rewrite, shared by the variant scripts
(``tail_variants.py`` for bf16 B3, ``probs_compare.py --f32 --phases`` for
the f32 walks): a kernel's tile loop with a ``clock64()`` stamp at the top
of its body and after each of its statements, which the script then builds
apart and reads back as the cycles of each statement."""

from __future__ import annotations


def stamp(tile: str, tiles: int, dest: str, slots: int, warps) -> str:
    """The stamp statement: lane 0 of each warp of the first CTA, on tiles
    1..``tiles`` (``tile`` the loop's tile index as a C expression),
    writes ``clock64()`` to ``dest[((tile - 1) * slots + ns++) * warps +
    warp]`` (``slots`` stamps a tile at most, ``warps`` the CTA's)."""
    return (f"if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 31) "
            f"== 0 && {tile} >= 1 && {tile} <= {tiles}) {dest}[(({tile} - 1)"
            f" * {slots} + ns++) * {warps} + threadIdx.x / 32] = clock64();")


def stamp_loop(text: str, start: int, line: str) -> tuple:
    """``text`` with the loop body that begins at ``start`` (just past the
    brace of its header) stamped: ``int ns = 0;`` and the stamp ``line``
    first, then ``line`` after each statement of the body, and of the bare
    ``{ }`` blocks in it, which run unconditionally (a statement with
    braces of its own is one: a loop, an ``if`` / ``else`` pair); and the
    statements, one a stamp after the first (whitespace collapsed, at most
    100 characters)."""
    lines = text[start:].split("\n")
    out, labels, stmt = [f"    int ns = 0;\n    {line}\n"], [], ""
    bare = []                # each open brace: a bare block (not a header's)?
    for k, src in enumerate(lines):
        code = src.split("//")[0].strip()
        for ch in code:
            if ch == "{":
                bare.append(code == "{" and not stmt and all(bare))
            elif ch == "}":
                if not bare:               # the loop's closing brace
                    end = start + len("\n".join(lines[:k])) + 1
                    return text[:start] + "".join(out) + text[end:], labels
                bare.pop()
        out.append(src + "\n")
        if code == "{" and bare[-1]:       # into a bare block
            continue
        if code and not code.startswith("#") and code != "}":
            stmt = f"{stmt} {code}" if stmt else code
        nxt = next((x.split("//")[0].strip() for x in lines[k + 1:]
                    if x.split("//")[0].strip()), "")
        if (all(bare) and stmt and code.endswith((";", "}")) and
                not nxt.startswith("else")):
            out.append(f"    {line}\n")
            labels.append(" ".join(stmt.split())[:100])
            stmt = ""
    raise ValueError("no end of the loop")
