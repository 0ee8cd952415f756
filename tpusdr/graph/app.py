"""App compiler: JSON graph specs with host IO nodes -> runnable pipeline.

The reference's applications build graphs that *contain* their endpoints —
HackrfSource feeding the pipeline, AacFileWriter consuming it
(nbfm_test.cpp:434-484).  Device graphs here are pure functions, so the app
compiler splits a spec into (host source) -> (device Graph) -> (host sink)
and wires them through the StreamRunner.

Recognized IO node types (beyond the compute registry):
  * "File":       {"path", "format"="int8", "loop"=false}       (FileReader)
  * "Socket":     {"host", "port", "format"="int8"}             (HackrfSource role)
  * "Synth":      {"kind"="fm", "sampleRate", ...}              (test source)
  * "WavWriter":  {"path", "sampleRate"}                        (AacFileWriter role)
  * "RawWriter":  {"path", "dtype"="float32"}
  * "NullSink":   {}                                            (ReadByteCountMonitor role)
"""

from __future__ import annotations

import json as _json
from typing import Mapping

import numpy as np

from tpusdr.graph.graph import _snake, build_graph
from tpusdr.graph.runner import RunStats, StreamRunner
from tpusdr.io import sinks as io_sinks
from tpusdr.io import sources as io_sources
from tpusdr.utils.logging import get_logger

log = get_logger("app")

_SOURCE_TYPES = {"File", "Socket", "Synth", "HackRfSource"}
_SINK_TYPES = {"WavWriter", "RawWriter", "NullSink", "AacWriter"}


class App:
    def __init__(self, source_factory, graph, sink, tick: int):
        self.source_factory = source_factory
        self.graph = graph
        self.sink = sink
        self.tick = tick
        self.runner = StreamRunner(graph)

    def run(self, max_blocks: int | None = None) -> RunStats:
        src = self.source_factory(self.tick)
        state, stats = self.runner.run(iter(src), self.sink, max_blocks=max_blocks)
        self.sink.close()
        return stats


def _make_source_factory(type_name: str, params: dict):
    p = {(_snake(k)): v for k, v in params.items()}
    if type_name == "File":
        fmt = p.get("format", p.get("input_format", "int8"))

        def make(tick_scalars):
            # graph granule counts scalars at the exposed input; interleaved
            # formats carry 2 scalars per complex sample
            block = tick_scalars if fmt == "cf32" else tick_scalars // 2
            return io_sources.FileIqSource(
                p["path"], block, fmt, loop=bool(p.get("loop", False))
            )

        return make, fmt
    if type_name in ("Socket", "HackRfSource"):
        fmt = p.get("format", "int8")
        if type_name == "HackRfSource":
            log.warning(
                "node type 'HackRfSource': no radio on the accelerator host; expecting "
                "a TCP IQ relay at %s:%s (the hackrf_transfer | nc idiom)",
                p.get("host", "localhost"),
                p.get("port", 5555),
            )

        def make(tick_scalars):
            block = tick_scalars if fmt == "cf32" else tick_scalars // 2
            return io_sources.SocketIqSource(
                p.get("host", "localhost"), int(p.get("port", 5555)), block, fmt
            )

        return make, fmt
    if type_name == "Synth":
        fmt = p.get("format", "cf32")
        fs = float(p.get("sample_rate", 1e6))
        kind = p.get("kind", "fm")

        def make(tick_scalars):
            block = tick_scalars if fmt == "cf32" else tick_scalars // 2
            if kind == "fm":
                return io_sources.SyntheticIqSource.fm(
                    block,
                    fs,
                    float(p.get("audio_hz", 1000.0)),
                    float(p.get("deviation", 75e3)),
                    float(p.get("carrier_offset", 0.0)),
                    fmt,
                    int(p["num_blocks"]) if "num_blocks" in p else None,
                )
            raise ValueError(f"unknown synth kind {kind!r}")

        return make, fmt
    raise KeyError(type_name)


def _make_sink(type_name: str, params: dict):
    p = {(_snake(k)): v for k, v in params.items()}
    if type_name in ("WavWriter", "AacWriter"):
        if type_name == "AacWriter":
            log.warning(
                "node type 'AacWriter': FFmpeg is out of scope; writing WAV "
                "to %s (transcode with ffmpeg afterwards if needed)",
                p["path"],
            )
        return io_sinks.WavSink(p["path"], float(p["sample_rate"]))
    if type_name == "RawWriter":
        return io_sinks.RawFileSink(p["path"], np.dtype(p.get("dtype", "float32")))
    if type_name == "NullSink":
        return io_sinks.NullSink()
    raise KeyError(type_name)


def compile_app(spec: Mapping | str, tick: int = 1 << 20) -> App:
    """Split a full-pipeline spec (with IO nodes) into source -> device
    graph -> sink and return a runnable App.

    Exactly one source node and one sink node are supported per app (the
    reference apps' shape); multi-output graphs remain available through
    the Graph API directly.
    """
    if isinstance(spec, str):
        spec = _json.loads(spec)
    nodes = dict(spec.get("nodes", {}))
    connections = list(spec.get("connections", []))

    sources = {n: s for n, s in nodes.items() if s.get("type") in _SOURCE_TYPES}
    sinks = {n: s for n, s in nodes.items() if s.get("type") in _SINK_TYPES}
    if len(sources) != 1 or len(sinks) != 1:
        raise ValueError(
            f"compile_app needs exactly 1 source + 1 sink node, got "
            f"{list(sources)} / {list(sinks)}"
        )
    (src_name, src_spec), (sink_name, sink_spec) = (
        next(iter(sources.items())),
        next(iter(sinks.items())),
    )

    compute_nodes = {
        n: s for n, s in nodes.items() if n not in sources and n not in sinks
    }

    input_ports = []
    outputs = None
    kept_connections = []
    for c in connections:
        if c["source"] == src_name:
            input_ports.append(
                {
                    "exposedPort": 0,
                    "mapped": {"node": c["sink"], "port": int(c.get("sinkPort", 0))},
                }
            )
        elif c["sink"] == sink_name:
            outputs = c["source"]
        else:
            kept_connections.append(c)
    if not input_ports or outputs is None:
        raise ValueError("source/sink nodes must be connected into the graph")

    graph = build_graph(
        {
            "nodes": compute_nodes,
            "connections": kept_connections,
            "inputPorts": input_ports,
            "outputPort": outputs,
        }
    )

    src_type = src_spec["type"]
    src_params = {k: v for k, v in src_spec.items() if k != "type"}
    source_factory, _fmt = _make_source_factory(src_type, src_params)
    sink = _make_sink(sink_spec["type"], {k: v for k, v in sink_spec.items() if k != "type"})

    g = max(1, tick // graph.granule) * graph.granule
    if g % 2 and _fmt != "cf32":
        g *= 2  # interleaved sources need an even scalar count
    return App(source_factory, graph, sink, g)
