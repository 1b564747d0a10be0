"""Time flash_bidir's launches that walk every key tile, in one checkout.

The plain-walk cases of the port's attention kernel on the card: route B
at the split refine's shape (q (16, 64, 32, 128) over 384 cache keys, the
block's 64 masked, + 64 buffer keys, BAOS, bf16), recurrentgemma-2b's warm
tick ((4, 96, 10 on 1, 256), kv_valid, no window and window 2048) and
llada-8b's main path ((4, 96, 32, 128), kv_valid, bf16 and f32).  Each is
three readings of the device time per call (chip_smoke.kernel_ms: 20 calls
in one CUDA graph).  Prints the card and one JSON line with the readings
and the registers of every flash_bidir instantiation.

To compare two commits on one card, unpack the other one (``git archive``)
into a directory that .gitignore lists and run both in one call, in the
order a, b, b, a:

    python3 tools/flash_bidir_ab.py build/parent parent
    python3 tools/flash_bidir_ab.py . change
"""
import json
import sys
from pathlib import Path


def main(tree: str, label: str) -> int:
    root = Path(tree).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch import device
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_bidir as fb
    if not torch.cuda.is_available():
        print("flash_bidir_ab: no CUDA device", file=sys.stderr)
        return 1
    device.resolve("cuda")
    _build.build()
    print(f"[{label}] {cs.card_line()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def ragged(S, lens):
        return torch.arange(S, device="cuda")[None, :] < torch.tensor(
            lens, device="cuda")[:, None]

    def three(fn, what):
        return [cs.kernel_ms(fn, 20, what) for _ in range(3)]

    out = {"label": label,
           "regs": {k: regs for lib, k, _, regs, _ in cs.kernel_attrs()
                    if lib == "flash_bidir"}}
    B, Sq, Skv, H, D, off = 16, 64, 384, 32, 128, 128
    q, k, v = r(B, Sq, H, D), r(B, Skv, H, D), r(B, Skv, H, D)
    k2, v2 = r(B, Sq, H, D), r(B, Sq, H, D)
    pos = torch.arange(Skv, device="cuda")
    valid = (~((pos >= off) & (pos < off + Sq))[None].expand(B, Skv)
             ).contiguous()
    cal = [torch.rand(B, H, D, generator=g, device="cuda") + 0.5,
           torch.rand(B, H, D, generator=g, device="cuda") + 0.5,
           torch.randn(B, H, D, generator=g, device="cuda")]
    kw = dict(q_offset=off, extra_kv=(k2, v2, None))
    out["route_b"] = three(
        lambda: fb.flash_bidir(q, k, v, valid, *cal, **kw), "route B")
    q, k, v = r(4, 96, 10, 256), r(4, 96, 1, 256), r(4, 96, 1, 256)
    valid = ragged(96, (96, 64, 48, 1))
    for win in (None, 2048):
        out[f"warm_tick_window_{win}"] = three(
            lambda: fb.flash_bidir(q, k, v, valid, window=win), "warm tick")
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (r(4, 96, 32, 128, dtype=dt) for _ in range(3))
        out[f"main_{str(dt).replace('torch.', '')}"] = three(
            lambda: fb.flash_bidir(q, k, v, valid), "main path")
    print(f"[{label}] " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
