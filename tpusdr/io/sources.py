"""Host-side IQ sources.

Each source is an iterator protocol over fixed-size numpy blocks (the host
side of the streaming tick).  Device upload happens in the StreamRunner;
sources never touch jax.

  * FileIqSource   — recorded capture playback (FileReader.cpp role:
                     64 KiB chunked fread, FileReader.cpp:48-66 — here a
                     numpy memmap sliced per tick, zero-copy on the host).
  * SocketIqSource — live IQ over TCP (the HackrfSource.cpp role: its USB
                     callback thread + BufferPool + condvar,
                     HackrfSource.cpp:175-201, becomes a reader thread +
                     bounded queue with the same drop-on-overrun policy).
  * SyntheticIqSource — deterministic test/bench signal generator.
  * CallbackSource — adapt any callable; the escape hatch for custom HW.
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Callable, Iterator

import numpy as np

from tpusdr.utils.logging import get_logger

log = get_logger("io")

_DTYPES = {
    "int8": np.int8,
    "int16": np.int16,
    "float32": np.float32,
}

#: wire-format -> upload dtype: integer IQ travels as PACKED WORDS, one per
#: complex sample (int8 pair -> int16 word, int16 pair -> int32 word).
#: Identical bytes; the word layout was chosen on the former target, where
#: sub-word int8 loads were slow (graph/blocks.py IqToComplex).
# queue sentinel: the reader's socket went silent (distinct from a clean
# EOF, which enqueues None) — the consumer raises TimeoutError on it
_SILENT = object()

_WORD_DTYPES = {
    "int8": np.int16,
    "int16": np.int32,
    "float32": np.float32,
}


class FileIqSource:
    """Interleaved-IQ file playback, ``block_samples`` *complex* samples per
    block.  Integer formats yield packed words (one per complex sample);
    'float32' yields 2x interleaved scalars; 'cf32' yields complex64."""

    def __init__(
        self,
        path: str,
        block_samples: int,
        input_format: str = "int8",
        loop: bool = False,
        max_blocks: int | None = None,
    ):
        self.path = path
        self.block = int(block_samples)
        self.format = input_format
        self.loop = loop
        self.max_blocks = max_blocks
        if input_format == "cf32":
            self._mm = np.memmap(path, dtype=np.complex64, mode="r")
            self._scalars_per_block = self.block
        elif input_format == "float32":
            self._mm = np.memmap(path, dtype=np.float32, mode="r")
            self._scalars_per_block = 2 * self.block
        else:  # packed-word integer formats: one word per complex sample
            self._mm = np.memmap(path, dtype=_WORD_DTYPES[input_format], mode="r")
            self._scalars_per_block = self.block

    def __iter__(self) -> Iterator[np.ndarray]:
        n = self._scalars_per_block
        emitted = 0
        while True:
            for i in range(0, (len(self._mm) // n) * n, n):
                yield np.asarray(self._mm[i : i + n])
                emitted += 1
                if self.max_blocks is not None and emitted >= self.max_blocks:
                    return
            if not self.loop:
                return

    @property
    def num_blocks(self) -> int:
        return len(self._mm) // self._scalars_per_block


class SyntheticIqSource:
    """Deterministic signal generator for tests/benches: a sum of tones
    and/or an FM-modulated carrier, emitted as interleaved int8/int16 or
    complex64 blocks."""

    def __init__(
        self,
        block_samples: int,
        sample_rate: float,
        make_block: Callable[[np.ndarray], np.ndarray],
        output_format: str = "cf32",
        num_blocks: int | None = None,
    ):
        self.block = int(block_samples)
        self.fs = sample_rate
        self.make_block = make_block
        self.format = output_format
        self.num_blocks = num_blocks

    @staticmethod
    def fm(
        block_samples: int,
        sample_rate: float,
        audio_hz: float = 1000.0,
        deviation: float = 75e3,
        carrier_offset: float = 0.0,
        output_format: str = "cf32",
        num_blocks: int | None = None,
        amplitude: float = 0.9,
    ) -> "SyntheticIqSource":
        """FM-modulated tone at ``carrier_offset`` from center.

        The phase uses the tone's closed-form integral, so it stays
        continuous across blocks of any length."""

        def make(t: np.ndarray) -> np.ndarray:
            w = 2 * np.pi * audio_hz
            phase = (
                2 * np.pi * carrier_offset * t
                + 2 * np.pi * deviation * (1.0 - np.cos(w * t)) / w
            )
            return (amplitude * np.exp(1j * phase)).astype(np.complex64)

        return SyntheticIqSource(
            block_samples, sample_rate, make, output_format, num_blocks
        )

    def __iter__(self) -> Iterator[np.ndarray]:
        i = 0
        emitted = 0
        while self.num_blocks is None or emitted < self.num_blocks:
            t = (np.arange(self.block) + i) / self.fs
            z = self.make_block(t)
            yield _format_iq(z, self.format)
            i += self.block
            emitted += 1


def _format_iq(z: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "cf32":
        return z.astype(np.complex64)
    inter = np.empty(2 * len(z), dtype=np.float32)
    inter[0::2] = z.real
    inter[1::2] = z.imag
    if fmt == "int8":  # packed words: one int16 per complex sample
        return np.clip(np.round(inter * 127.0), -128, 127).astype(np.int8).view(
            np.int16
        )
    if fmt == "int16":  # packed words: one int32 per complex sample
        return (
            np.clip(np.round(inter * 32767.0), -32768, 32767)
            .astype(np.int16)
            .view(np.int32)
        )
    return inter


class SocketIqSource:
    """Live IQ over a TCP socket with a bounded pool and drop-on-overrun.

    Mirrors the HackrfSource ingest structure exactly (HackrfSource.cpp:
    RX-callback thread -> BufferPool::tryGetBuffer -> deque + condvar, drop
    + "buffer underrun" log on pool exhaustion :182-187; consumer blocks
    with a timeout :306-318) — with the USB callback replaced by a socket
    reader thread.
    """

    def __init__(
        self,
        host: str,
        port: int,
        block_samples: int,
        input_format: str = "int8",
        pool_blocks: int = 3,  # reference default queue depth (nbfm_test.cpp:439)
        timeout_s: float = 5.0,  # reference read timeout (HackrfSource.cpp:36)
    ):
        self.addr = (host, port)
        self.block = int(block_samples)
        self.format = input_format
        # integer IQ is yielded as packed words, one per complex sample
        # (same bytes off the wire; see _WORD_DTYPES)
        dtype = _WORD_DTYPES[input_format]
        self._itemsize = np.dtype(dtype).itemsize
        self._scalars = 2 * self.block if input_format == "float32" else self.block
        self._dtype = dtype
        # queue items: (start_byte_offset, block) — offsets are the wire
        # position of the block's first byte, the currency of the
        # retune-flush protocol (skip_until_byte)
        self._q: queue.Queue[tuple[int, np.ndarray] | None] = queue.Queue(
            maxsize=pool_blocks
        )
        self.timeout_s = timeout_s
        self.dropped_blocks = 0
        #: blocks discarded by skip_until_byte (retune flush)
        self.flushed_blocks = 0
        self._skip_until = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _reader(self, sock: socket.socket) -> None:
        nbytes = self._scalars * self._itemsize
        buf = b""
        framed = 0  # wire byte offset of the next block's first byte
        try:
            while not self._stop.is_set():
                while len(buf) < nbytes:
                    try:
                        chunk = sock.recv(1 << 16)
                    except TimeoutError as e:
                        # the wire went silent: propagate as the
                        # HackrfSource-style read timeout.  The consumer's
                        # own q.get timer covers the same condition; this
                        # sentinel makes whoever fires first report the SAME
                        # outcome instead of racing a clean EOF against a
                        # TimeoutError (r4 load flake, tests/test_io.py).
                        log.warning("socket ingest reader timed out: %s", e)
                        self._q.put(_SILENT)
                        return
                    except OSError as e:
                        # socket died: end the stream like a device unplug
                        log.warning("socket ingest reader stopped: %s", e)
                        self._q.put(None)
                        return
                    if not chunk:
                        self._q.put(None)
                        return
                    buf += chunk
                block = np.frombuffer(buf[:nbytes], dtype=self._dtype).copy()
                buf = buf[nbytes:]
                start = framed
                framed += nbytes
                try:
                    self._q.put_nowait((start, block))
                except queue.Full:
                    self.dropped_blocks += 1
                    if self.dropped_blocks % 100 == 1:
                        log.warning(
                            "socket ingest overrun: dropped %d blocks",
                            self.dropped_blocks,
                        )
        finally:
            sock.close()

    def skip_until_byte(self, wire_pos: int) -> None:
        """Retune flush: discard every block containing wire bytes before
        ``wire_pos`` (the server-reported stream position at which a
        reconfiguration — e.g. a set_frequency — took effect).  Samples
        captured at the old radio center still in flight (TCP buffers, the
        reader queue) must not be demodulated with the new NCO; the
        reference gets the same clean cut from its stop/start framing
        (HackrfSource.cpp:263-283).  Blocks straddling the boundary are
        dropped whole."""
        self._skip_until = max(self._skip_until, int(wire_pos))

    def __iter__(self) -> Iterator[np.ndarray]:
        sock = socket.create_connection(self.addr, timeout=self.timeout_s)
        sock.settimeout(self.timeout_s)
        self._thread = threading.Thread(
            target=self._reader, args=(sock,), daemon=True
        )
        self._thread.start()
        while True:
            try:
                item = self._q.get(timeout=self.timeout_s)
            except queue.Empty:
                raise TimeoutError(
                    f"no IQ data within {self.timeout_s}s (HackrfSource-style "
                    "read timeout)"
                )
            if item is _SILENT:
                raise TimeoutError(
                    f"no IQ data within {self.timeout_s}s (HackrfSource-style "
                    "read timeout)"
                )
            if item is None:
                return
            start, block = item
            if start < self._skip_until:
                self.flushed_blocks += 1
                continue
            yield block

    def close(self) -> None:
        self._stop.set()


class CallbackSource:
    """Wrap a callable ``f(block_index) -> np.ndarray | None`` as a source."""

    def __init__(self, fn: Callable[[int], np.ndarray | None]):
        self.fn = fn

    def __iter__(self) -> Iterator[np.ndarray]:
        i = 0
        while True:
            b = self.fn(i)
            if b is None:
                return
            yield b
            i += 1
