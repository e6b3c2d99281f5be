"""Reader combinators (``paddle_tpu/v2/reader/decorator.py``; the
reference's python/paddle/v2/reader/decorator.py)."""

from __future__ import annotations

import heapq
import itertools
import random
import subprocess
from queue import Queue
from threading import Thread


class ComposeNotAligned(ValueError):
    """compose(check_alignment=True) found readers of different length
    (reference: decorator.py ComposeNotAligned)."""


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    def reader():
        for r in readers:
            for e in r():
                yield e

    return reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            while True:
                outputs = []
                stops = 0
                for r in rs:
                    try:
                        outputs.append(next(r))
                    except StopIteration:
                        stops += 1
                if stops:
                    if stops != len(rs):
                        raise ComposeNotAligned(
                            "outputs of readers are not aligned")
                    return
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    break
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Prefetch into a bounded queue on a worker thread."""

    class _End:
        pass

    def data_reader():
        q: Queue = Queue(maxsize=size)

        def fill():
            for d in reader():
                q.put(d)
            q.put(_End)

        t = Thread(target=fill)
        t.daemon = True
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return data_reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return data_reader


def cache(reader):
    all_data = []
    filled = []

    def data_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        for d in all_data:
            yield d

    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map samples through ``mapper`` on ``process_num`` worker threads
    with a ``buffer_size``-bounded pipeline (reference: decorator.py
    xmap_readers).  With ``order=True`` output order matches input order
    — realized here by index-tagging samples and heap-reordering at the
    consumer (the reference busy-waits writers instead)."""
    _end = object()

    class _Raise:
        def __init__(self, exc):
            self.exc = exc

    def xreader():
        in_q: Queue = Queue(buffer_size)
        out_q: Queue = Queue(buffer_size)

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    in_q.put((i, sample))
            except BaseException as e:  # re-raised by the consumer
                out_q.put(_Raise(e))
            finally:
                for _ in range(process_num):
                    in_q.put(_end)

        def work():
            while True:
                item = in_q.get()
                if item is _end:
                    out_q.put(_end)
                    return
                i, sample = item
                try:
                    out_q.put((i, mapper(sample)))
                except BaseException as e:  # re-raised by the consumer
                    out_q.put(_Raise(e))
                    out_q.put(_end)
                    return

        threads = [Thread(target=feed, daemon=True)]
        threads += [Thread(target=work, daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()

        finished = 0
        if not order:
            while finished < process_num:
                item = out_q.get()
                if item is _end:
                    finished += 1
                elif isinstance(item, _Raise):
                    raise item.exc
                else:
                    yield item[1]
            return
        heap: list = []
        next_idx = 0
        while finished < process_num or heap:
            while heap and heap[0][0] == next_idx:
                yield heapq.heappop(heap)[1]
                next_idx += 1
            if finished == process_num:
                continue
            item = out_q.get()
            if item is _end:
                finished += 1
            elif isinstance(item, _Raise):
                raise item.exc
            else:
                heapq.heappush(heap, item)

    return xreader


def pipe_reader(left_cmd, parser=None, bufsize=8192, line_break="\n"):
    """Stream samples out of a shell pipeline (reference: decorator.py
    pipe_reader — e.g. ``left_cmd="hadoop fs -cat /data/*.gz | gunzip"``).
    ``parser(lines)`` maps an iterable of text lines to samples; the
    default yields the stripped lines themselves."""
    if parser is None:
        def parser(lines):
            for ln in lines:
                yield ln

    def lines_of(proc):
        # split on BYTES and decode whole lines only — a multibyte
        # character straddling a read boundary must not be decoded in
        # halves
        sep = line_break.encode("utf-8")
        remained = b""
        while True:
            buf = proc.stdout.read(bufsize)
            if not buf:
                break
            parts = (remained + buf).split(sep)
            remained = parts.pop()
            for ln in parts:
                yield ln.decode("utf-8", errors="replace").rstrip("\r")
        if remained:
            yield remained.decode("utf-8", errors="replace").rstrip("\r")

    def reader():
        proc = subprocess.Popen(left_cmd, shell=True,
                                stdout=subprocess.PIPE, bufsize=bufsize)
        try:
            for sample in parser(lines_of(proc)):
                yield sample
        finally:
            proc.stdout.close()
            rc = proc.wait()
        if rc != 0:
            raise RuntimeError(
                f"pipe_reader command failed with exit status {rc}: "
                f"{left_cmd!r}")

    return reader
