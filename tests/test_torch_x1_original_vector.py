"""X1's original-layout route (``zo_threefry_original``) as the kernel
walks it, emulated on the CPU: the launches of ``original_launches``, each
split by ``original_split`` into the scalar head, the zone of 16-byte
vector runs (site 1 on y's grid, site 2 shifted d = h mod R words, its
vectors taking their first d words from the lane below or, at a lane-0
run, from the carry of the previous warp-run's lane 31), the junction
vectors between chunks of runs, and the scalar tail.

For every dtype × dist (R = 2, 4 or 8 pairs a vector), word counts m odd
and even, every residue of h mod R, a last word whole or partial, x and y
misaligned (all scalar), windows whose ends lie off the grid, windows whose
pair ranges meet or not, and windows at key blocks past 2³² − 1 words:

* every element of the window is written exactly once, and nothing else;
* each write reads the word of its own pair and site (the word the
  emulated lanes hold after the rotation and the shuffles);
* every 16-byte access lies on 16 bytes in x and y."""
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels.threefry import kernel as X1

#: (dtype, dist) -> (bits a word's element, bytes an element)
CASES = {(dt, dist): (X1.bit_width(dt, dist), dt.itemsize)
         for dt in (torch.float32, torch.bfloat16, torch.float16)
         for dist in ("gaussian", "rademacher")}
IDS = [f"{str(dt)[6:]}-{dist}" for dt, dist in CASES]
BASE = 1 << 20          # y's address: on 16 bytes


def _emulate(ln, sp, e_lo, e_hi, off, bw, size, x_addr, y_addr, ch, hits):
    """Walk one launch as ``orig_kernel`` does, adding each written draw
    element to ``hits``; assert every write's word and alignment."""
    epw = 32 // bw
    R, d = sp.R, sp.d
    N = R * epw
    e1 = (ln.wbase + ln.p0) * epw
    e2 = e1 + ln.h * epw
    has = {1: sp.hi1 > sp.lo1, 2: sp.hi2 > sp.lo2}
    win = {1: (sp.lo1, sp.hi1), 2: (sp.lo2, sp.hi2)}
    base = {1: e1, 2: e2}

    def write(site, rel, pair, j, vector=False):
        """Element j of the word hashed for ``pair`` at ``site``, at the
        site's relative element ``rel``."""
        assert rel == pair * epw + j, (site, rel, pair, j)
        lo, hi = win[site]
        if not lo <= rel < hi:
            assert not vector, (site, rel)
            return
        e = base[site] + rel
        assert e_lo <= e < e_hi
        word = ln.wbase + ln.p0 + pair + (ln.h if site == 2 else 0)
        assert e // epw == word
        hits[e] = hits.get(e, 0) + 1

    def vector(site, rel0, words):
        """A 16-byte vector at relative element rel0 from R words (pairs)."""
        addr = y_addr + (base[site] - off + rel0) * size
        assert addr % 16 == 0, (site, rel0)
        if x_addr is not None:
            assert (x_addr + (base[site] - off + rel0) * size) % 16 == 0
        for r, pair in enumerate(words):
            for j in range(epw):
                write(site, rel0 + r * epw + j, pair, j, vector=True)

    # the zone, CH runs a chunk (a warp walks a chunk 32 runs at a time)
    nchunks = -(-sp.nrun // ch) if sp.nrun else 0
    for c in range(nchunks):
        j0, j1 = c * ch, min(c * ch + ch, sp.nrun)
        carry = None
        for jb in range(j0, j1, 32):
            rot = []
            for lane in range(32):
                q = sp.qz + (jb + lane) * R
                own = [q + r for r in range(R)]          # pairs hashed
                rot.append([own[(r - d) % R] for r in range(R)])
            for lane in range(32):
                j = jb + lane
                if j >= j1:
                    continue
                q = sp.qz + j * R
                if has[1]:
                    vector(1, q * epw, [q + r for r in range(R)])
                if has[2] and (d == 0 or lane > 0 or jb > j0):
                    src = carry if lane == 0 else rot[lane - 1]
                    v = [src[r] if r < d else rot[lane][r] for r in range(R)]
                    assert v == [q - d + r for r in range(R)]
                    vector(2, (q - d) * epw, v)
            carry = rot[31]
    # junction vectors: the site-2 vector across each chunk's edge
    if has[2] and d and sp.nrun:
        zone = range(sp.qz, sp.qz + sp.nrun * R)
        for i in range(nchunks + 1):
            b = min(i * ch, sp.nrun)
            pairs = [sp.qz + b * R - d + r for r in range(R)]
            if all(p in zone for p in pairs):
                vector(2, pairs[0] * epw, pairs)
            else:
                for p in pairs:
                    if p in zone:
                        for j in range(epw):
                            write(2, p * epw + j, p, j)
    # the scalar loop: the head and the tail, both sites
    tail = sp.qz + sp.nrun * R
    for q in list(range(0, sp.qz)) + list(range(tail, ln.np)):
        for site in (1, 2):
            for j in range(epw):
                write(site, q * epw + j, q, j)


def _walk(lo, hi, n, bw, size, x_addr, y_addr,
          chunks=(X1.ORIG_CHUNK, 32, 96)):
    """Every launch of the window [lo, hi) of an n-element draw, walked at
    the kernel's chunk size and others; returns the routes and the zone's
    runs."""
    routes, runs = set(), 0
    for ch in chunks:
        hits = {}
        for ln in X1.original_launches(lo, hi, n, bw):
            sp = X1.original_split(ln, lo, hi, lo, bw, size, x_addr, y_addr)
            assert sp.R * (32 // bw) * size == 16
            routes.add(sp.route)
            runs += sp.nrun
            _emulate(ln, sp, lo, hi, lo, bw, size, x_addr, y_addr, ch, hits)
        assert len(hits) == hi - lo and set(hits.values()) == {1}, (
            "missed or written twice",
            sorted(e for e in range(lo, hi) if hits.get(e) != 1)[:8])
    return routes, runs


@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_whole_leaves_every_residue_of_h(case):
    """Whole leaves of odd and even m, h over every residue mod R, the last
    word whole or partial: written once, nearly all in vectors."""
    bw, size = CASES[case]
    epw = 32 // bw
    R = 16 // (epw * size)
    for res in range(R):
        h = 160 * R + res                # > 64 runs: three chunks of 64
        for m in (2 * h, 2 * h - 1):
            for n in {m * epw, m * epw - (epw - 1)}:
                routes, runs = _walk(0, n, n, bw, size, BASE, BASE)
                assert routes == {"vector"}
                assert runs * R >= h - 2 * R, (res, m, n, runs)
                sp = X1.original_split(X1.original_launches(0, n, n, bw)[0],
                                       0, n, 0, bw, size, None, BASE)
                assert sp.d == h % R


@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_misaligned_x_and_y_run_all_scalar(case):
    """x and y that lie differently against 16 bytes, or y's words off
    its grid: the all-scalar route, still written once."""
    bw, size = CASES[case]
    epw = 32 // bw
    n = 2 * (64 * epw * 8) + 3
    for x_addr, y_addr in ((BASE + 16 - size, BASE), (BASE, BASE + size)):
        routes, runs = _walk(0, n, n, bw, size, x_addr, y_addr)
        assert routes == {"scalar"} and runs == 0
    # z form (no x), y one element off 16 bytes: its words off the grid
    # where a word holds several elements, else a grid that starts later
    routes, runs = _walk(0, n, n, bw, size, None, BASE + size)
    assert routes == ({"scalar"} if epw > 1 else {"vector"})
    assert (runs == 0) == (epw > 1)


@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_windows_off_the_grid(case):
    """Windows whose ends lie off the vector grid and off word edges:
    inside the first half, inside the second, straddling h with their pair
    ranges meeting (one pair range) or not (two), and nearly the whole
    draw; y[0] is the window's first element, on 16 bytes."""
    bw, size = CASES[case]
    epw = 32 // bw
    R = 16 // (epw * size)
    for res in (0, R - 1):
        h = 40 * R + res
        m = 2 * h - 1
        n = m * epw - (epw - 1)
        H = h * epw                      # site 2's first element
        for lo, hi in ((3, H // 2 + 5), (H + 7, n - 2), (H // 3 + 1, H + 9),
                       (H - 11, H + H // 2 + 3), (1, n - 1), (H - 1, H + 1)):
            lo_e = lo - lo % epw          # y[0] on a word edge
            routes, _ = _walk(lo_e, hi, n, bw, size, BASE, BASE)
            assert routes == {"vector"}
            _walk(lo, hi, n, bw, size, BASE, BASE)


@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_windows_at_key_blocks_past_2_32_words(case):
    """Windows of virtual draws past 2³² − 1 words: at the edge between two
    key blocks and at the last block's half (a launch never straddles a
    block)."""
    bw, size = CASES[case]
    epw = 32 // bw
    B = X1.BLOCK_WORDS
    for m in (B + 2 * 300 + 1, 2 * B + 2 * 257):
        n = m * epw - (epw - 1)
        hb = (m - B + 1) // 2 if m < 2 * B else (m - 2 * B + 1) // 2
        last = (m // B) * B               # the last block's first word
        for lo_w, hi_w in ((B - 40, B + 90), (last + hb - 70, last + hb + 50),
                           (last, m)):
            lo, hi = lo_w * epw, min(hi_w * epw, n)
            lns = X1.original_launches(lo, hi, n, bw)
            assert all(ln.wbase % B == 0 and ln.p0 + ln.np <= ln.h
                       for ln in lns)
            _walk(lo, hi, n, bw, size, BASE, BASE)


def test_launches_are_cut_for_32_bit_indices():
    """A block's pair range is cut at ``ORIG_LAUNCH_PAIRS`` pairs, so every
    element index inside a launch stays below 2³¹."""
    n = 3 * X1.ORIG_LAUNCH_PAIRS * 2 * 4 + 13        # bf16: 4 a word
    lns = X1.original_launches(0, n, n, 8)
    assert len(lns) == 4 and sum(ln.np for ln in lns) == lns[0].h
    assert all(ln.np <= X1.ORIG_LAUNCH_PAIRS for ln in lns)
    assert all(ln.np * 4 <= 1 << 31 for ln in lns)
    sp = X1.original_split(lns[1], 0, n, 0, 8, 2, BASE, BASE)
    assert sp.route == "vector" and sp.hi1 == lns[1].np * 4
