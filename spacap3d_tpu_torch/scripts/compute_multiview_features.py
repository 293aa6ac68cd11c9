"""Per-frame ENet features, as the JAX package's
``scripts/compute_multiview_features.py`` (reference
scripts/compute_multiview_features.py:29-131):

    python -m spacap3d_tpu_torch.scripts.compute_multiview_features \\
        --frames_root F --out_root O [--enet_ckpt scannetv2_enet.pth] [--device cuda]

Reads ``<frames_root>/<scene>/color/<frame>.jpg`` (or ``.png``), runs the
ENet encoder over batches of ``--batch_size`` frames resized to
``--image_h`` x ``--image_w``, and writes ``<out_root>/<scene>/<frame>.npy``:
the (H/8, W/8, 128) float32 feature map, channel last, as the JAX CLI writes
it. ``--enet_ckpt`` is a reference ``.pth`` or a pickle of the JAX package's
numpy trees (``utils/convert_enet.py::load_enet``); without one the weights
are seeded random. ``--device`` (default ``cuda``, which raises without
CUDA; ``cpu`` when asked) is the port's own.
"""
import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--enet_ckpt", default="",
                   help="torch scannetv2_enet.pth or native pickle")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_h", type=int, default=256)
    p.add_argument("--image_w", type=int, default=328)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs ENet on the CPU")
    return p.parse_args(argv)


def load_image(path, h, w):
    import numpy as np
    try:
        from PIL import Image
        img = np.asarray(Image.open(path).convert("RGB").resize((w, h)))
    except ImportError:
        import imageio.v2 as imageio  # pragma: no cover
        img = imageio.imread(path)
    return img.astype("float32") / 255.0


def encode_frames(model, imgs):
    """ENet features of ``imgs`` (B, H, W, 3) float32 -> (B, H/8, W/8, 128)
    float32 numpy, channel last."""
    import torch

    dev = next(model.parameters()).device
    with torch.no_grad():
        feats = model.encode(torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2))
    return feats.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from spacap3d_tpu_torch.utils.convert_enet import load_enet

    model = load_enet(args.enet_ckpt, device=args.device)
    scenes = sorted(os.listdir(args.frames_root))
    for scene in scenes:
        color_dir = os.path.join(args.frames_root, scene, "color")
        if not os.path.isdir(color_dir):
            continue
        out_dir = os.path.join(args.out_root, scene)
        os.makedirs(out_dir, exist_ok=True)
        frames = sorted(os.listdir(color_dir))
        for i in range(0, len(frames), args.batch_size):
            chunk = frames[i:i + args.batch_size]
            imgs = np.stack([
                load_image(os.path.join(color_dir, fr), args.image_h, args.image_w)
                for fr in chunk
            ])
            for fr, fm in zip(chunk, encode_frames(model, imgs)):
                np.save(os.path.join(out_dir, os.path.splitext(fr)[0] + ".npy"), fm)
        print(f"{scene}: {len(frames)} frames")


if __name__ == "__main__":
    main()
