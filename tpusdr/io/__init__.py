"""tpusdr.io — host-side stream ingest and egress.

The analog of the reference's CPU-side endpoints: FileReader
(/root/reference/src/filters/FileReader.cpp), HackrfSource (live USB RX,
HackrfSource.cpp — no radio on the accelerator host, so the live path is a TCP/UDP IQ
socket), and AacFileWriter (AacFileWriter.cpp — FFmpeg is out of scope, so
audio lands as WAV/raw PCM; see SURVEY.md section 2.9).
"""

from tpusdr.io.sources import (  # noqa: F401
    CallbackSource,
    FileIqSource,
    SocketIqSource,
    SyntheticIqSource,
)
from tpusdr.io.sinks import (  # noqa: F401
    CollectSink,
    NullSink,
    RawFileSink,
    WavSink,
)
from tpusdr.io.shim import (  # noqa: F401
    FakeSdrDriver,
    RfShim,
    SdrDriver,
    Station,
)
