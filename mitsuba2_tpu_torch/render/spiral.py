"""Spiral block iterator (parity: include/mitsuba/render/spiral.h and
``mitsuba2_tpu.render.spiral``): the reference's render loop pulls image
blocks in an outward spiral from the center, so that early progress shows
the subject first.

The port renders whole passes, so this is a utility for block-progressive
work (previews, checkpointed tiles): it yields (offset, size) block
windows in spiral order.
"""

from __future__ import annotations


class Spiral:
    def __init__(self, size, block_size: int = 32):
        self.size = tuple(int(x) for x in size)
        self.block_size = int(block_size)
        self.blocks_x = -(-self.size[0] // self.block_size)
        self.blocks_y = -(-self.size[1] // self.block_size)
        self.block_count = self.blocks_x * self.blocks_y
        self.reset()

    def reset(self):
        # start at the center block, step right, turn counter-clockwise
        self._pos = ((self.blocks_x - 1) // 2, (self.blocks_y - 1) // 2)
        self._dir = (1, 0)
        self._steps = 1
        self._step_i = 0
        self._turns = 0
        self._emitted = 0

    def max_block_size(self):
        return self.block_size

    def next_block(self):
        """-> ((x, y), (w, h)) pixel window, or None when exhausted."""
        while self._emitted < self.block_count:
            bx, by = self._pos
            # advance the spiral walk
            self._step_i += 1
            self._pos = (bx + self._dir[0], by + self._dir[1])
            if self._step_i == self._steps:
                self._step_i = 0
                dx, dy = self._dir
                self._dir = (-dy, dx)          # turn left (ccw)
                self._turns += 1
                if self._turns % 2 == 0:
                    self._steps += 1
            if 0 <= bx < self.blocks_x and 0 <= by < self.blocks_y:
                self._emitted += 1
                x = bx * self.block_size
                y = by * self.block_size
                w = min(self.block_size, self.size[0] - x)
                h = min(self.block_size, self.size[1] - y)
                return (x, y), (w, h)
        return None

    def __iter__(self):
        self.reset()
        while True:
            blk = self.next_block()
            if blk is None:
                return
            yield blk
