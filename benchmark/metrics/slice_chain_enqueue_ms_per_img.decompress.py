"""Host milliseconds an image for which ms2020's slice-chain spans
(``ms2020/slice_params`` and ``ms2020/slice_lrp``) were open over the
window's decompress calls: the time the host takes to enqueue the chain's
networks, against the device time ``slice_chain_ms_per_img.decompress``
reads. A program without those spans gives None."""

from benchmark import spans

CHAIN = ("ms2020/slice_params", "ms2020/slice_lrp")


def read(record):
    images = record.get("window_images", {}).get("decompress")
    parts = [spans._per(record, "span_s", "decompress", name, images) for name in CHAIN]
    return None if None in parts else sum(parts)
