"""The work of the codec's ops at a cell's shapes, and the chip's peaks:
the numerators of the rooflines and of `mfu`.

Frozen copies of chip_smoke.py's peaks (:282-291) and cost functions
(`gdn_cost`, `deconv_igdn_cost`, `gdn_backward_cost`,
`gdn_backward_tc_bound`, `bound_ms`: :373-420, :501-525), with one
correction: a float32 product's least time is taken at the 3xTF32 rate
(a third of TF32's), which the port already takes as float32-accurate
(GDN's backward on the tensor cores), and elementwise work at the CUDA
cores' float32 rate beside it; bf16 activations are 2 bytes a value and
their products run at the bf16 rate. Each cost returns (bytes, product
FLOPs, elementwise FLOPs).

The launches come from the configuration's layers (`reference.codec.
stacks`) walked at the cell's shapes, not from the program's records: a
serving trip runs compress (the encoder heads, g_a, h_a, and h_s for the
indexes) and decompress (g_s or the upsample stacks, then the decoder
heads) with every deconv5x5/2 followed by an (I)GDN fused into one
deconv+IGDN launch; a train step runs the noise-quantized forward with
every layer on its own and GDN's backward once per (I)GDN.
"""

from .reference import codec

# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12       # CUDA cores
TF32_FLOP_PER_S = 495e12     # tensor cores
F32X3_FLOP_PER_S = TF32_FLOP_PER_S / 3   # 3xTF32: float32-accurate
BF16_FLOP_PER_S = 989e12
F32, BF16 = 4, 2  # bytes a value


def product_rate(elt):
    return BF16_FLOP_PER_S if elt == BF16 else F32X3_FLOP_PER_S


def bound_s(cost, elt):
    """Least seconds for (bytes, products, elementwise): the largest of
    bytes over HBM's rate, products over the tensor cores' rate at the
    precision and elementwise work over the CUDA cores' (side by side)."""
    n_bytes, products, elementwise = cost
    return max(n_bytes / HBM_BYTES_PER_S, products / product_rate(elt),
               elementwise / F32_FLOP_PER_S)


def gdn_cost(n, c, elt=F32):
    """One (I)GDN on (n, c): x read and out written (`elt` bytes), gamma
    and beta (float32); the C x C product as 2 n C^2 FLOPs, x^2, (r)sqrt
    and the multiply as 3 n C."""
    return 2 * n * c * elt + (c * c + c) * F32, 2 * n * c * c, 3 * n * c


def deconv_igdn_cost(b, h, w, cin, cout, mode, elt=F32):
    """One deconv5x5/2 (+ the (I)GDN epilogue where `mode`) of x (b, h, w,
    cin): taps on the zero padding not counted ((5H-3)(5W-3) input-tap
    pairs an image and channel pair; of the weights only the rows and
    columns that reach the image, 2 of 5 along an extent of 1)."""
    taps = (5 * h - 3) * (5 * w - 3)
    kernel_taps = (2 if h == 1 else 5) * (2 if w == 1 else 5)
    out_pix = b * 4 * h * w
    products = 2 * b * taps * cin * cout
    elementwise = out_pix * cout
    n_bytes = ((b * h * w * cin + out_pix * cout) * elt
               + (kernel_taps * cin * cout + cout) * F32)
    if mode is not None:
        products += 2 * out_pix * cout * cout
        elementwise += 3 * out_pix * cout
        n_bytes += (cout * cout + cout) * F32
    return n_bytes, products, elementwise


def gdn_backward_cost(n, c, elt=F32):
    """GDN's closed-form backward on (n, c): x and the gradient read, dx
    written (`elt` bytes), gamma and beta read and their gradients written
    (float32); u @ gamma and u^T @ x^2 and the norm again as 6 n C^2
    FLOPs, ~12 elementwise operations a value."""
    return (3 * n * c * elt + (2 * c * c + 2 * c) * F32,
            6 * n * c * c, 12 * n * c)


def gdn_backward_bound_s(n, c, elt=F32):
    """The lesser of the backward's bound with its products on the CUDA
    cores and with them on the tensor cores (3xTF32)."""
    cost = gdn_backward_cost(n, c, elt)
    cuda_cores = max(cost[0] / HBM_BYTES_PER_S,
                     (cost[1] + cost[2]) / F32_FLOP_PER_S)
    return min(cuda_cores, bound_s(cost, elt))


# -- the layers at a cell's shapes ------------------------------------------

def _extent(n, la):
    """Output extent of a layer on an input extent n."""
    if la.kind == "conv":
        return -(-n // la.s)
    if la.kind == "deconv":
        return n * la.s
    return n


def valid_taps(n, la):
    """Kernel taps along one axis that reach the image, summed over the
    outputs (conv) or the inputs (deconv) of extent n's layer."""
    k, s, p = la.k, la.s, la.k // 2
    if la.kind == "conv":
        return sum(sum(1 for t in range(k) if 0 <= o * s - p + t < n)
                   for o in range(-(-n // s)))
    out = n * s
    return sum(sum(1 for t in range(k) if 0 <= i * s - p + t < out)
               for i in range(n))


def _walk(layers, b, n, fuse):
    """[(op, shape)] of `layers` on a batch of b at extent n: ops "conv",
    "deconv", "gdn", "igdn", "deconv_igdn" (fused, when `fuse`), "relu";
    returns them and the output extent."""
    ops, i = [], 0
    while i < len(layers):
        la = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if (fuse and la.kind == "deconv" and la.k == 5 and la.s == 2
                and nxt is not None and nxt.kind in ("gdn", "igdn")):
            ops.append(("deconv_igdn", (b, n, n, la.cin, la.cout, nxt.kind),
                        la))
            n = _extent(n, la)
            i += 2
            continue
        if la.kind in ("gdn", "igdn"):
            ops.append((la.kind, (b * n * n, la.cin), la))
        elif la.kind in ("conv", "deconv"):
            ops.append((la.kind, (b, n, la.cin, la.cout), la))
        n = _extent(n, la)
        i += 1
    return ops, n


def trip_ops(cfg, b, program):
    """The ops of one serving trip ("trip": compress + decompress, fused)
    or one train step's forward ("train": unfused) of a batch of b."""
    st = codec.stacks(cfg)
    fuse = program == "trip"
    size = cfg["image_size"]
    ops, n = [], size
    for head in st["input_heads"]:
        head_ops, n = _walk(head, b, size, fuse)
        ops += head_ops
    ga, n_y = _walk(st["g_a"], b, n, fuse)
    ha, n_z = _walk(st["h_a"], b, n_y, fuse)
    hs, _ = _walk(st["h_s"], b, n_z, fuse)
    ops += ga + ha + hs
    n = n_y
    if st["g_s"] is not None:
        gs, n = _walk(st["g_s"], b, n_y, fuse)
        ops += gs
    for head in st["output_heads"]:
        ops += _walk(head, b, n, fuse)[0]
    return ops


def products(op, shape, la):
    """Product FLOPs of one op (taps that reach the image only)."""
    if op in ("gdn", "igdn"):
        n, c = shape
        return 2 * n * c * c
    if op == "deconv_igdn":
        b, h, w, cin, cout, _ = shape
        return deconv_igdn_cost(b, h, w, cin, cout, "igdn")[1]
    if op in ("conv", "deconv"):
        b, n, cin, cout = shape
        return 2 * b * valid_taps(n, la) ** 2 * cin * cout
    return 0


def model_products(cfg, b, program):
    """Product FLOPs of a trip or of one train step's forward."""
    return sum(products(op, shape, la)
               for op, shape, la in trip_ops(cfg, b, program))


def launches(cfg, b, program, elt=F32):
    """{kernel: [bound seconds of each launch]} of the port's kernels in
    one trip ("gdn", "deconv_igdn") or one train step ("gdn",
    "gdn_backward")."""
    out = {"gdn": [], "deconv_igdn": [], "gdn_backward": []}
    for op, shape, _ in trip_ops(cfg, b, program):
        if op in ("gdn", "igdn"):
            out["gdn"].append(bound_s(gdn_cost(*shape, elt), elt))
            if program == "train":
                out["gdn_backward"].append(gdn_backward_bound_s(*shape, elt))
        elif op == "deconv_igdn":
            bb, h, w, cin, cout, mode = shape
            out["deconv_igdn"].append(bound_s(
                deconv_igdn_cost(bb, h, w, cin, cout, mode, elt), elt))
    return {k: v for k, v in out.items() if v}


def peak_flops(elt):
    return product_rate(elt)


def elt_of(dtype_name):
    return BF16 if dtype_name == "bfloat16" else F32

