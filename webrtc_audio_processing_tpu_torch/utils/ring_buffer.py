"""Single-producer single-consumer ring buffer over numpy arrays.

The port's own copy of ``webrtc_audio_processing_tpu/utils/ring_buffer.py``
(pure Python and numpy; nothing of it is shared with the JAX package).

Reference: common_audio/ring_buffer.{h,c} (WebRtc_CreateBuffer /
ReadBuffer / WriteBuffer / MoveReadPtr / available_read / available_write
semantics, including negative MoveReadPtr "stuffing" that rewinds the
read pointer into zero-history).

Host-side utility for IO plumbing around the device step; on the device
the ring pattern is index arithmetic on tensors instead (see
models/aec3/render_buffer.py). The device-facing SPSC queues live in
native/streaming_plane.cc.
"""

from __future__ import annotations

import numpy as np


class RingBuffer:
    """element_count slots of shape `element_shape` (float32 default)."""

    def __init__(self, element_count: int, element_shape=(),
                 dtype=np.float32):
        self._n = int(element_count)
        self._data = np.zeros((self._n, *element_shape), dtype)
        self.init()

    def init(self) -> None:
        """WebRtc_InitBuffer: empty buffer, SAME_WRAP."""
        self._read = 0
        self._write = 0
        self._same_wrap = True
        self._data[:] = 0

    def available_read(self) -> int:
        if self._same_wrap:
            return self._write - self._read
        return self._n - self._read + self._write

    def available_write(self) -> int:
        return self._n - self.available_read()

    def write(self, data: np.ndarray) -> int:
        """Writes up to available_write elements; returns elements written."""
        data = np.asarray(data)
        n = min(len(data), self.available_write())
        margin = self._n - self._write
        if n > margin:
            self._data[self._write:] = data[:margin]
            self._data[: n - margin] = data[margin:n]
            self._write = n - margin
            self._same_wrap = False
        else:
            self._data[self._write:self._write + n] = data[:n]
            self._write += n
            if self._write == self._n:
                self._write = 0
                self._same_wrap = False
        return n

    def read(self, element_count: int) -> np.ndarray:
        """Reads up to element_count elements (copy); advances read pos."""
        n = min(element_count, self.available_read())
        margin = self._n - self._read
        if n > margin:
            out = np.concatenate(
                [self._data[self._read:], self._data[: n - margin]]
            )
        else:
            out = self._data[self._read:self._read + n].copy()
        self.move_read_ptr(n)
        return out

    def move_read_ptr(self, element_count: int) -> int:
        """WebRtc_MoveReadPtr (ring_buffer.c:172-207): positive flushes,
        negative stuffs (rewinds into the zero history)."""
        free = self.available_write()
        read_avail = self.available_read()
        n = min(element_count, read_avail)
        n = max(n, -free)
        read = self._read + n
        if read >= self._n:
            read -= self._n
            self._same_wrap = True
        elif read < 0:
            read += self._n
            self._same_wrap = False
        self._read = read
        return n
