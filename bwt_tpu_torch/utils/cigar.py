"""CIGAR run-length stack (stack.c:5-86).

Pushes merge with the top entry when the op matches (stack.c:62-66);
``flip_onto`` pops one stack onto another, reversing order
(stack.c:51-59); rendering pops top-first (stack.c:27-37).
"""

from __future__ import annotations


class Cigar:
    """Run-length stack of (op, count); top of stack = end of list."""

    __slots__ = ("ops",)

    def __init__(self):
        self.ops: list[list] = []  # [op_char, count]

    def push(self, op: str, count: int) -> None:
        if self.ops and self.ops[-1][0] == op:
            self.ops[-1][1] += count
        else:
            self.ops.append([op, int(count)])

    def flip_onto(self, other: "Cigar") -> None:
        """Pop everything onto ``other`` (stack.c:51-59); empties self."""
        while self.ops:
            op, count = self.ops.pop()
            other.push(op, count)

    def reset(self) -> None:
        """The reference's ``s->size = 0`` (single_align.c:279)."""
        self.ops.clear()

    def render(self) -> str:
        """Top-first run-length string (stack_print_destroy order)."""
        return "".join(f"{count}{op}" for op, count in reversed(self.ops))

    def render_ref_line(self) -> str:
        """Byte-exact stack_print_destroy output (stack.c:27-37)."""
        return " " + self.render() + "\n"

    def __bool__(self) -> bool:
        return bool(self.ops)

    def __repr__(self) -> str:
        return f"Cigar({self.render()!r})"
