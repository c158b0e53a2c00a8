"""Per cent of the card's float32 peak (67 TFLOP/s, TF32 off) in the
rematch's DKMv3 work (work_dkm.py: an encoder pass a view, both decoder
passes an ordered pair) over the seconds of the program's `dkm.encode` and
`dkm.decode` spans.  A `dkm.decode` span also holds its pair batch's host
work after the decoder (`_to_kpts`: the columns' gather and their copy to
the host, which waits on the device), so this is the matcher's share as
the rematch runs it, not its kernels' alone."""

from perfbench import work_dkm


def read(r):
    spans, counts = r.setup["spans_s"], r.setup["counts"]
    enc, dec = spans.get("dkm.encode"), spans.get("dkm.decode")
    views, pairs = counts.get("rematch.views"), counts.get("rematch.pairs")
    if enc is None or dec is None or not views or "dkm_view_flop" not in r.work:
        return None
    flop = views * r.work["dkm_view_flop"] + pairs * r.work["dkm_pair_flop"]
    return work_dkm.mfu(flop, enc + dec)
