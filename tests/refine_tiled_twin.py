"""The host twin of K6's tiled wide layout (csrc/refine.cu refine_layout
with scan_plan), for the CPU tests (tests/test_torch_refine_tiled.py,
test_torch_refine_past_4096.py) and the card test that holds the
kernel's own layout to it (tests/test_torch_cuda.py test_refine_layout).
It imports nothing of JAX: the card's test process has none.
"""


def layout(T, D, K, S, wide, rows):
    """The kernel's block (csrc/refine.cu refine_layout) on the wide
    mapping: the scan block's threads (a fusion group each, at most 1024),
    its shared bytes (two frames of forms staged where they, the publish
    areas and the partials take at most 200 KB; two publish areas of
    (2D+1)*K/S floats unless in the carry; two positions' warp partials),
    and a track's carry: T-2 suffix and T-2 prefix frames of forms (each
    state block padded to 4 slots), the pair kernel's partials (ceil(K/S
    / rows) row tiles a state block and position, padded to 4 floats),
    with wide = 2 the publish areas (padded to 4)."""
    pad4 = lambda n: -(-n // 4) * 4                       # noqa: E731
    G = K // S
    threads = min(1024, -(-G // 32) * 32)
    nrt = -(-G // rows)
    ring = 2 * (threads // 32) * (2 + 2 * D)
    pubs = 2 * (2 * D + 1) * G
    frame = {1: 4, 2: 5, 3: 8}[D] * S * pad4(G)
    staged = 2 * frame
    if wide == 2 or 4 * (staged + pubs + ring) > 200 * 1024:
        staged = 0
    carry = (2 * max(T - 2, 0) * frame
             + pad4(max(T - 2, 0) * S * nrt * (2 + 2 * D))
             + (pad4(pubs) if wide == 2 else 0))
    return (threads, 4 * (staged + (0 if wide == 2 else pubs) + ring),
            4 * carry)
