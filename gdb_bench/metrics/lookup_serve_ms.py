"""The server's answer to one lookup
(`query/stream.CombinedRecordStream.bcf_stream`, timed from the call
until its generator is exhausted, so the socket writes the server
interleaves with it are inside), in ms per call."""

SPANS = {"bcf_stream":
         "genomicsdb_tpu_torch.query.stream:CombinedRecordStream.bcf_stream"}


def read(view):
    return view.mean_ms("bcf_stream")
