"""Thin web frontend over the headless edit sessions: the exploration
server.

Counterpart of ``exsr/apps/web.py``: a stdlib ``http.server`` serving one
canvas page and a JSON API over the port's
:class:`~exsr_torch.apps.session.EditSession` (SR) or
:class:`~exsr_torch.apps.jpeg_session.JPEGEditSession` (JPEG).  Covered
tools: open an image (HR or LR; a real JPEG by its own coefficients),
rectangle and polygon regions, uniform-Z and SVD sliders, the gradient
edit loop for every objective of the session, scribbles with brightness
classes, random alternatives, imprints, HSV edits, SVHN digit
exploration, undo/redo, Z save/load, the downscaling kernel (bicubic,
blurry, KernelGAN estimate) and the plain-ESRGAN comparison view.

Requests are served one at a time (:meth:`SessionApi.dispatch` holds a
lock): each handler thread works on the session's own device, and the
sessions switch TF32 off inside the lock (:func:`exsr_torch.device.
full_fp32`).

Run::

  python -m exsr_torch.apps.web --port 8000 [--image PATH] [--nb 23] \\
      [--checkpoint CKPT] [--mode jpeg] [--device cpu]

It serves on the current CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from exsr_torch.device import full_fp32


def _png_bytes(img01: np.ndarray) -> bytes:
    """[H, W, 3] float in [0,1] -> PNG bytes."""
    from PIL import Image
    arr = np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()


def _decode_image(b64: str) -> np.ndarray:
    from PIL import Image
    raw = base64.b64decode(b64.split(',')[-1])
    img = Image.open(io.BytesIO(raw)).convert('RGB')
    return np.asarray(img).astype(np.float32) / 255.0


# class ids are painted as gray value id * _SCRIBBLE_QUANT on the mask
# canvas: wide buckets survive canvas antialiasing / premultiplied-alpha
# round-trips that corrupt raw 1..4 values at stroke edges.  16-wide
# buckets keep ids up to 15 inside the 0..255 gray range (TV region ids
# auto-increment from 4; the client wraps at 15)
_SCRIBBLE_QUANT = 16


def _decode_scribble_mask(b64: str) -> np.ndarray:
    from PIL import Image
    raw = base64.b64decode(b64.split(',')[-1])
    img = Image.open(io.BytesIO(raw)).convert('RGBA')
    arr = np.asarray(img).astype(np.float32)
    if arr[..., 0].max() <= 8:
        # legacy wire format: raw class ids as gray values (pre-bucket
        # clients) — still accepted
        ids = np.round(arr[..., 0]).astype(int)
    else:
        ids = np.round(arr[..., 0] / _SCRIBBLE_QUANT).astype(int)
    ids[arr[..., 3] < 128] = 0  # antialiased fringe -> background
    return ids


class SessionApi:
    """JSON API over one EditSession (thread-serialized: edits are
    long-running device programs, so requests take a lock the same way the
    Qt GUI serializes through its event loop)."""

    def __init__(self, session):
        self.session = session
        self.lock = threading.Lock()
        self.alternatives = 1

    # every handler returns a JSON-able dict
    def open(self, req):
        img = _decode_image(req['image'])
        sr = self.session.open_image(img, is_hr=bool(req.get('is_hr', True)))
        return {'sr_shape': list(sr.shape),
                'lr_shape': list(self.session.lr_image.shape)}

    def view(self, req):
        which = req.get('which', 'sr')
        s = self.session
        if which == 'esrgan':
            # the plain-ESRGAN comparison view
            if getattr(s, '_esrgan', None) is None:
                return {'error': 'no ESRGAN model attached — start the '
                                 'server with --esrgan'}
            if s.lr_image is None:
                return {'error': 'no image open'}
            return {'png': base64.b64encode(
                _png_bytes(s.esrgan_sr()[0])).decode()}
        img = {'sr': None if s.sr is None else s.sr[0],
               'lr': None if s.lr_image is None else s.lr_image[0],
               'gt': None if s.hr_gt is None else s.hr_gt[0],
               'z': None if s.cur_z is None else
               (s.cur_z[0] / (2 * s.z_range) + 0.5)}[which]
        if img is None:
            return {'error': f'no {which} image'}
        return {'png': base64.b64encode(_png_bytes(img)).decode()}

    def region(self, req):
        s = self.session
        h, w = s.region_mask_hr.shape
        mask = np.zeros((h, w), np.float32)
        if 'rect' in req:
            y0, x0, y1, x1 = [int(v) for v in req['rect']]
            mask[max(0, y0):y1, max(0, x0):x1] = 1.0
        elif 'polygon' in req:
            mask = _polygon_mask(req['polygon'], (h, w))
        else:
            return {'error': 'rect or polygon required'}
        s.set_region(mask)
        return {'selected_px': int(mask.sum())}

    def clear_region(self, req):
        self.session.clear_region()
        return {'ok': True}

    def invert_region(self, req):
        """Invert_Z_Mask (GUI.py:1424)."""
        self.session.invert_region()
        return {'ok': True,
                'selected_px': int(self.session.region_mask_hr.sum())}

    def alternative(self, req):
        """Browse or adopt a retained random alternative
        (GUI.py:1420-1421,1740-1800): ``index`` selects it, ``copy:
        true`` runs CopyAlternative2Default (Z adopted inside the
        region), ``push: true`` runs CopyDefault2Alternative (cur_Z
        pushed into every alternative inside the region)."""
        if req.get('push'):
            self.session.copy_default_to_alternatives()
            return {'ok': True}
        i = int(req.get('index', 0))
        if req.get('copy'):
            self.session.copy_alternative(i)
            return {'ok': True}
        img = self.session.alternative_sr(i)
        return {'png': base64.b64encode(_png_bytes(img[0])).decode()}

    def optimize(self, req):
        data = dict(req.get('data') or {})
        if isinstance(data.get('desired'), str):
            data['desired'] = _decode_image(data['desired'])[None]
        if isinstance(data.get('scribble_mask'), str):
            data['scribble_mask'] = _decode_scribble_mask(
                data['scribble_mask'])
        if 'desired' not in data and 'l1' in req['objective']:
            data['desired'] = self.session.sr
        out = self.session.optimize(
            req['objective'], data=data,
            max_iters=req.get('max_iters'),
            time_budget_s=req.get('time_budget_s'),
            n_alternatives=int(req.get('n_alternatives',
                                       self.alternatives)))
        return {'final_loss': out['final_loss'], 'rounds': out['rounds'],
                'losses': out['losses'][-10:],
                'n_alternatives': out.get('n_alternatives', 0)}

    def uniform_z(self, req):
        self.session.set_uniform_z(req['values'])
        return {'ok': True}

    def svd(self, req):
        self.session.set_z_from_svd(float(req['lambda0']),
                                    float(req['lambda1']),
                                    float(req['theta']))
        return {'ok': True}

    def undo(self, req):
        self.session.undo()
        return {'ok': True}

    def redo(self, req):
        self.session.redo()
        return {'ok': True}

    def save_z(self, req):
        self.session.save_z(req['path'])
        return {'ok': True, 'path': req['path']}

    def load_z(self, req):
        self.session.load_z(req['path'])
        return {'ok': True}

    def save_outputs(self, req):
        """save_file_and_Z_map (GUI.py:1411): write the current output
        and the Z map as PNGs (Z scaled so neutral Z=0 encodes as 127 —
        the wire format region_from_z reads back)."""
        s = self.session
        if s.sr is None:
            return {'error': 'no image open'}
        from PIL import Image
        prefix = req['path']
        out_p, z_p = prefix + '_out.png', prefix + '_Z.png'
        Image.fromarray((np.clip(s.sr[0], 0, 1) * 255 + 0.5)
                        .astype(np.uint8)).save(out_p)
        z = s.cur_z[0]
        if z.shape[-1] > 3:
            z = z[..., :3]
        elif z.shape[-1] < 3:
            z = np.concatenate([z] + [np.zeros_like(z[..., :1])]
                               * (3 - z.shape[-1]), -1)
        # truncating cast: neutral Z=0 lands exactly on 127, the value
        # region_from_z (and the reference's Load_Z_mask) tests against
        Image.fromarray(np.clip(
            (z / (2 * s.z_range) + 0.5) * 255, 0, 255)
            .astype(np.uint8)).save(z_p)
        return {'out': out_p, 'z': z_p}

    def region_from_z(self, req):
        """Load_Z_mask (GUI.py:1425): derive the editing mask from a
        saved Z-map PNG — the pixels whose Z differs from neutral 127."""
        if 'image' in req:
            arr = _decode_image(req['image'])
        else:
            from PIL import Image
            arr = np.asarray(Image.open(req['path'])).astype(np.float32) \
                / 255.0
        if arr.ndim == 2:          # grayscale Z-map PNG
            mask = np.abs(arr - 127.0 / 255.0) > 0.5 / 255.0
        else:
            mask = np.any(np.abs(arr[..., :3] - 127.0 / 255.0)
                          > 0.5 / 255.0, axis=-1)
        s = self.session
        if mask.shape != s.region_mask_hr.shape:
            return {'error': f'Z map shape {mask.shape} does not match '
                             f'the open image {s.region_mask_hr.shape}'}
        s.set_region(mask.astype(np.float32))
        return {'selected_px': int(s.region_mask_hr.sum())}

    def kernel(self, req):
        kind = req.get('kind', 'bicubic')
        if kind == 'bicubic':
            self.session.set_kernel(None)
        elif kind == 'estimate':
            self.session.estimate_kernel(
                max_iters=int(req.get('max_iters', 3000)))
        elif kind.startswith('blurry_cubic_'):
            self.session.set_kernel(kind)
        else:
            return {'error': f'unknown kernel kind {kind}'}
        return {'ok': True,
                'margins_lr': int(self.session.cem.invalidity_margins_lr)}

    def periodicity(self, req):
        vecs = self.session.estimate_periodicity(req['origin'],
                                                 req['points'])
        return {'vectors': [list(map(float, v)) for v in vecs]}

    # -------- imprint / HSV / digit tools (GUI.py:857-1283, 1552-1585,
    # 1517-1547 — the editing pillar beyond masked objectives) --------
    def _decode_imprint(self, req):
        imp = _decode_image(req['image'])
        if req.get('size'):
            from PIL import Image
            h, w = [int(v) for v in req['size']]
            imp = np.asarray(Image.fromarray(
                (imp * 255 + 0.5).astype(np.uint8)).resize(
                    (w, h), Image.BILINEAR)).astype(np.float32) / 255.0
        if req.get('angle'):
            from PIL import Image
            imp = np.asarray(Image.fromarray(
                (imp * 255 + 0.5).astype(np.uint8)).rotate(
                    float(req['angle']), Image.BILINEAR)
                ).astype(np.float32) / 255.0
        return imp

    def _search_mask(self, req):
        s = self.session
        if 'search_rect' in req:
            mask = np.zeros(s.region_mask_hr.shape, np.float32)
            y0, x0, y1, x1 = [int(v) for v in req['search_rect']]
            mask[max(0, y0):y1, max(0, x0):x1] = 1.0
            return mask
        m = s.region_mask_hr
        return m if m.min() < 1 else np.ones_like(m)

    def find_imprint_location(self, req):
        """Auto-location search only (FindOptimalImprintingLocation,
        GUI.py:887-961) — returns the best placement without committing."""
        imp = self._decode_imprint(req)
        found = self.session.find_optimal_imprint_location(
            imp, self._search_mask(req),
            n_trials=int(req.get('n_trials', 200)),
            seed=int(req.get('seed', 0)))
        return {'position': [int(v) for v in found['position']],
                'consistency_error': float(found['consistency_error'])}

    def imprint(self, req):
        """Place an imprint (uploaded image) at a given or auto-located HR
        position: composite, enforce LR-consistency, pull Z toward it
        (GUI.py:857-1283 imprinting flow).  ``transparent: true`` color-
        keys the imprint: pixels matching ``transparent_color`` (default
        white, +-2 graylevels, morphologically closed) keep the current
        output — the special-behavior toggle of finalize_imprinting
        (GUI.py:880,1125-1131)."""
        imp = self._decode_imprint(req)
        imprint_mask = None
        if req.get('transparent'):
            from scipy import ndimage
            color = np.asarray(req.get('transparent_color',
                                       [255, 255, 255]), np.float32)
            d = np.sqrt(np.mean(
                (np.round(imp * 255) - color) ** 2, -1))
            # edge-pad before closing: scipy's border_value=0 erosion
            # would delete the 1-px border of the transparency mask
            # (cv2 MORPH_CLOSE in the reference is border-neutral)
            padded = np.pad(d <= 2.0, 1, mode='edge')
            tmask = ndimage.binary_closing(
                padded, structure=ndimage.generate_binary_structure(
                    2, 1))[1:-1, 1:-1]
            imprint_mask = 1.0 - tmask.astype(np.float32)
        result = {}
        pos = req.get('position')
        if pos is None or req.get('auto'):
            found = self.session.find_optimal_imprint_location(
                imp, self._search_mask(req),
                n_trials=int(req.get('n_trials', 200)),
                seed=int(req.get('seed', 0)))
            pos = found['position']
            result['consistency_error'] = float(found['consistency_error'])
        out = self.session.imprint(
            imp, (int(pos[0]), int(pos[1])),
            optimize_iters=int(req.get('optimize_iters', 25)),
            imprint_mask=imprint_mask)
        result.update({'position': [int(pos[0]), int(pos[1])],
                       'final_loss': out['final_loss'],
                       'rounds': out['rounds']})
        return result

    def hsv(self, req):
        """HSV edit via consistency enforcement (GUI.py:1552-1585): scale
        hue/saturation/value of the current SR inside the selected region,
        make it LR-consistent, and pull Z toward the result."""
        s = self.session
        if s.sr is None:
            return {'error': 'no image open'}
        from PIL import Image
        cur = np.clip(np.asarray(s.sr[0]), 0, 1)
        hsv = np.asarray(Image.fromarray(
            (cur * 255 + 0.5).astype(np.uint8)).convert('HSV'),
            dtype=np.float32)
        hsv[..., 0] = (hsv[..., 0]
                       + float(req.get('hue_shift', 0.0)) / 360.0 * 255.0
                       ) % 255.0
        hsv[..., 1] = np.clip(hsv[..., 1] * float(req.get('sat', 1.0)),
                              0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] * float(req.get('val', 1.0)),
                              0, 255)
        edited = np.asarray(Image.fromarray(
            hsv.astype(np.uint8), mode='HSV').convert('RGB'),
            dtype=np.float32) / 255.0
        m = s.region_mask_hr[..., None]
        edited = m * edited + (1 - m) * cur
        consistent = s.enforce_hsv_edit(edited)
        out = s.optimize(
            'l1', data={'desired': consistent[None].astype(np.float32)},
            max_iters=int(req.get('optimize_iters', 25)))
        return {'final_loss': out['final_loss'], 'rounds': out['rounds']}

    def _get_svhn_apply(self, wkey: str):
        """The SVHN classifier's apply function on the session's device,
        in fp32 with TF32 off, cached by its weights path (the reference
        ``.pth``; seeded random weights when empty): a later request with
        real weights must not reuse a random classifier."""
        if getattr(self, '_svhn_key', None) != wkey:
            from exsr_torch.models.classifiers import (
                SVHNClassifier, load_svhn_torch_state_dict)
            clf = SVHNClassifier(seed=0)
            if wkey:
                clf.load_state_dict(load_svhn_torch_state_dict(wkey))
            clf = clf.to(self.session._device).requires_grad_(False)

            def apply(x):
                with full_fp32():
                    return clf(x)
            self._svhn_apply = apply
            self._svhn_key = wkey
        return self._svhn_apply

    def digit(self, req):
        """SVHN digit exploration (GUI.py:1517-1547): optimize Z so the
        selected region classifies as the requested digit."""
        apply_fn = self._get_svhn_apply(req.get('weights') or '')
        out = self.session.optimize(
            'digit',
            data={'classifier_apply': apply_fn,
                  'digit_2_resemble': int(req.get('digit', 0)),
                  'multiview_classification':
                      tuple(req.get('multiview', (1, 3)))},
            max_iters=req.get('max_iters'),
            time_budget_s=req.get('time_budget_s'))
        return {'final_loss': out['final_loss'], 'rounds': out['rounds']}

    def state(self, req):
        s = self.session
        return {'has_image': s.lr_image is not None,
                'can_undo': len(s._history) > 0,
                'can_redo': len(s._redo) > 0,
                'scale': s.scale,
                'estimated_kernel': s.estimated_kernel is not None}

    def dispatch(self, name: str, req: dict) -> dict:
        fn = getattr(self, name, None)
        if fn is None or name.startswith('_') or name == 'dispatch':
            return {'error': f'unknown endpoint {name}'}
        with self.lock:
            return fn(req)


class JpegSessionApi(SessionApi):
    """JSON API over a JPEGEditSession — same endpoint vocabulary as the
    SR API where the concepts coincide (open/view/region/optimize/
    uniform_z/undo/redo/state), JPEG-specific semantics where not
    (GUI's JPEG mode: Y channel, 8x8-block region smearing, QF;
    GUI.py:2328-2352 / DecompCNN_model.py:293-314)."""

    def open(self, req):
        raw = base64.b64decode(req['image'].split(',')[-1])
        if raw[:2] == b'\xff\xd8' and not req.get('recompress'):
            # real baseline JPEG: edit ITS quantized coefficients
            # (exact DQT), not a recompression
            from exsr_torch.jpeg.jfif import UnsupportedJPEGError
            try:
                out = self.session.open_jpeg_bytes(raw)
                return {'out_shape': list(out.shape),
                        'qf': float(self.session.qf),
                        'source': 'jpeg-coefficients'}
            except UnsupportedJPEGError:
                pass  # progressive etc. — fall back to recompression
        img = _decode_image(req['image'])
        out = self.session.open_image(img, qf=req.get('qf'))
        return {'out_shape': list(out.shape),
                'qf': float(self.session.qf), 'source': 'recompressed'}

    def view(self, req):
        s = self.session
        which = req.get('which', 'out')
        if which == 'out':
            img = None if s.out is None else s.out[0]
        elif which == 'rgb':
            img = None if s.out is None else s.compose_rgb()
        elif which == 'input':  # plain JPEG decode of the input coeffs
            # pass the exact file DQT (q=) like every other session path,
            # so the displayed input matches the true decode for
            # real-file opens (recompute uses the same table)
            img = None if s.comp is None else _plain_decode(s)
        elif which == 'z':
            img = (None if s.cur_z is None
                   else s.cur_z[0, :, :, :3] * 0.5 + 0.5)
        else:
            return {'error': f'unknown view {which}'}
        if img is None:
            return {'error': f'no {which} image'}
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return {'png': base64.b64encode(_png_bytes(img)).decode()}

    def region(self, req):
        s = self.session
        h, w = s.region_mask.shape
        mask = np.zeros((h, w), np.float32)
        if 'rect' in req:
            y0, x0, y1, x1 = [int(v) for v in req['rect']]
            mask[max(0, y0):y1, max(0, x0):x1] = 1.0
        elif 'polygon' in req:
            mask = _polygon_mask(req['polygon'], (h, w))
        else:
            return {'error': 'rect or polygon required'}
        s.set_region(mask)  # smeared to whole 8x8 blocks inside
        return {'selected_px': int(s.region_mask.sum())}

    def clear_region(self, req):
        s = self.session
        s.set_region(np.ones(s.region_mask.shape, np.float32))
        return {'ok': True}

    def invert_region(self, req):
        """Invert_Z_Mask (GUI.py:1424) — stays 8x8-block aligned."""
        s = self.session
        s.set_region(1.0 - s.region_mask)
        return {'ok': True, 'selected_px': int(s.region_mask.sum())}

    def alternative(self, req):
        """Browse/adopt/push retained random alternatives — the
        reference's ProcessRandZ flow is task-agnostic and reachable
        from the JPEG GUI too (GUI.py:1476,1833)."""
        if req.get('push'):
            self.session.copy_default_to_alternatives()
            return {'ok': True}
        i = int(req.get('index', 0))
        if req.get('copy'):
            self.session.copy_alternative(i)
            return {'ok': True}
        img = np.repeat(self.session.alternative_out(i)[0], 3, axis=-1)
        return {'png': base64.b64encode(_png_bytes(img)).decode()}

    def save_outputs(self, req):
        """save_file_and_Z_map, JPEG flavor (GUI.py:1411): decoded
        output (color recomposition) — the 64-channel DCT-domain Z has
        no PNG wire format, so no Z map is written."""
        s = self.session
        if s.out is None:
            return {'error': 'no image open'}
        from PIL import Image
        out_p = req['path'] + '_out.png'
        img = s.compose_rgb()
        Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5)
                        .astype(np.uint8)).save(out_p)
        return {'out': out_p}

    def region_from_z(self, req):
        return {'error': 'Z-map PNGs are SR-only (JPEG Z lives in the '
                         'DCT domain)'}

    def optimize(self, req):
        from exsr_torch.utils.color import rgb2ycbcr
        data = dict(req.get('data') or {})
        if isinstance(data.get('scribble_mask'), str):
            data['scribble_mask'] = _decode_scribble_mask(
                data['scribble_mask'])
        if isinstance(data.get('desired'), str):
            rgb = _decode_image(data['desired'])
            if 'scribble' in req['objective']:
                # raw RGB — the session converts with its own open-time
                # Y convention (full-range vs studio-swing)
                data['desired'] = rgb
            elif getattr(self.session, '_ycbcr_full_range', False):
                # real-file opens decode with full-range JFIF Y; the
                # studio-swing conversion would bias the l1 target
                data['desired'] = (rgb @ np.array(
                    [0.299, 0.587, 0.114], np.float32))[None, ..., None]
            else:
                data['desired'] = rgb2ycbcr(
                    rgb, only_y=True)[None, ..., None]
        if 'desired' not in data and 'l1' in req['objective']:
            data['desired'] = self.session.out
        out = self.session.optimize(
            req['objective'], data=data,
            max_iters=int(req.get('max_iters', 25)),
            n_alternatives=int(req.get('n_alternatives', 1)))
        losses = [float(v) for v in np.asarray(out['losses']).ravel()]
        return {'final_loss': losses[-1] if losses else None,
                'losses': losses[-10:],
                'n_alternatives': out.get('n_alternatives', 0)}

    def uniform_z(self, req):
        vals = req['values']
        self.session.set_uniform_z3(vals[:3])
        return {'ok': True}

    def svd(self, req):
        return {'error': 'svd control is SR-only'}

    def kernel(self, req):
        return {'error': 'kernel estimation is SR-only'}

    def periodicity(self, req):
        return {'error': 'periodicity estimation is SR-only'}

    def save_z(self, req):
        np.savez(req['path'], z=self.session.cur_z)
        return {'ok': True, 'path': req['path']}

    def load_z(self, req):
        self.session.cur_z = np.load(req['path'])['z']
        self.session.recompute()
        return {'ok': True}

    def imprint(self, req):
        """JPEG imprint: composite the uploaded image's Y channel at the
        given position and pull Z toward it within the footprint (the
        JPEG GUI's imprint flow; border refinement is available at the
        session level via find_optimal_imprint_mask, GUI.py:963-1048)."""
        s = self.session
        if s.out is None:
            return {'error': 'no image open'}
        from exsr_torch.utils.color import rgb2ycbcr
        imp = self._decode_imprint(req)  # shared decode+resize+rotate
        imp_y = rgb2ycbcr(imp, only_y=True)
        pos = req.get('position', [0, 0])
        y, x = int(pos[0]), int(pos[1])
        desired = np.asarray(s.out[0, :, :, 0]).copy()
        # crop to the canvas like EditSession.imprint — a border position
        # keeps the visible part instead of shape-erroring
        ih = min(imp_y.shape[0], desired.shape[0] - y)
        iw = min(imp_y.shape[1], desired.shape[1] - x)
        if ih <= 0 or iw <= 0:
            return {'error': f'imprint position {[y, x]} is outside '
                             'the image'}
        desired[y:y + ih, x:x + iw] = imp_y[:ih, :iw]
        mask = np.zeros(s.region_mask.shape, np.float32)
        mask[y:y + ih, x:x + iw] = 1.0
        s.set_region(mask)
        out = s.optimize(
            'l1', data={'desired': desired[None, ..., None]},
            max_iters=int(req.get('optimize_iters', 25)))
        losses = [float(v) for v in np.asarray(out['losses']).ravel()]
        return {'position': [y, x],
                'final_loss': losses[-1] if losses else None}

    def find_imprint_location(self, req):
        return {'error': 'auto-location is SR-only; the JPEG session '
                         'refines imprint rects via '
                         'find_optimal_imprint_mask instead'}

    def hsv(self, req):
        """HSV manipulation — wired for the JPEG GUI in the reference too
        (Manipulate_HSV writes through the block-smeared mask built in
        update_HR_mask_display_size, GUI.py:475-480,1552-1585). The
        decoded output is Y-only, so only the value channel is realizable
        by the latent; hue/sat are reported as not applicable instead of
        silently dropped."""
        s = self.session
        if s.out is None:
            return {'error': 'no image open'}
        val = float(req.get('val', 1.0))
        note = None
        if float(req.get('hue_shift', 0.0)) or \
                float(req.get('sat', 1.0)) != 1.0:
            note = ('hue/sat have no effect: the JPEG latent controls '
                    'the Y channel only (chroma comes from the chroma '
                    'decoder)')
        cur = np.clip(s.out[0, :, :, 0], 0, 1)
        m = s.region_mask
        desired = m * np.clip(cur * val, 0, 1) + (1 - m) * cur
        out = s.optimize('l1', data={'desired': desired[None, ..., None]},
                         max_iters=int(req.get('optimize_iters', 25)))
        losses = [float(v) for v in np.asarray(out['losses']).ravel()]
        resp = {'final_loss': losses[-1] if losses else None}
        if note:
            resp['note'] = note
        return resp

    def digit(self, req):
        """SVHN digit exploration on the decoded Y channel — the tool's
        home configuration in the reference, where the classifier is
        loaded only for the JPEG GUI (GUI.py:1332,1393-1397,1517-1547).

        ``auto: true`` runs the reference's default Auto_Explore_Digits
        flow (GUI.py:1517-1539): optimize toward each digit 0-9, score
        each result with the classifier, keep only single-digit decodings,
        and leave the session displaying the most likely one.
        """
        apply_fn = self._get_svhn_apply(req.get('weights') or '')
        s = self.session
        mv = tuple(req.get('multiview', (1, 3)))
        iters = int(req.get('max_iters', 25))
        ckey = req.get('weights') or ''
        if not req.get('auto'):
            out = s.optimize(
                'digit',
                data={'classifier_apply': apply_fn,
                      'classifier_cache_key': ckey,
                      'digit_2_resemble': int(req.get('digit', 0)),
                      'multiview_classification': mv},
                max_iters=iters)
            losses = [float(v) for v in np.asarray(out['losses']).ravel()]
            return {'final_loss': losses[-1] if losses else None}
        from exsr_torch.zopt import objectives as obj
        mask = s.region_mask
        ys, xs = np.nonzero(mask > 0)
        bounds = (int(ys.min()), int(xs.min()), int(ys.max()),
                  int(xs.max()))
        transform = obj.digit_views_transform(bounds, mv)
        per = {}
        best_d, best_p = None, -1.0
        for d in range(10):
            s.optimize('digit',
                       data={'classifier_apply': apply_fn,
                             'classifier_cache_key': ckey,
                             'digit_2_resemble': d,
                             'multiview_classification': mv},
                       max_iters=iters)
            num, prob = obj.digit_score(apply_fn, transform, s._t(s.out),
                                        d)
            if num == 1:  # keep only single-digit decodings (GUI.py:1526)
                per[d] = {'z': s.cur_z.copy(), 'prob': prob}
                if prob > best_p:
                    best_d, best_p = d, prob
            s.undo()
        if best_d is not None:
            s._push()
            s.cur_z = per[best_d]['z']
            s.recompute()
        return {'per_digit_prob': {d: v['prob'] for d, v in per.items()},
                'most_likely': best_d,
                'prob': best_p if best_d is not None else None}

    def state(self, req):
        s = self.session
        return {'has_image': s.comp is not None,
                'can_undo': len(s._history) > 0,
                'can_redo': len(s._redo) > 0,
                'qf': float(s.qf),
                'mode': 'jpeg'}


@torch.no_grad()
def _plain_decode(s) -> np.ndarray:
    """``[H, W, 1]`` in [0, 1]: the codec's plain decode of a JPEG
    session's quantised input coefficients, by the file's own table when
    it has one (the table every other session path decodes with)."""
    with full_fp32():
        img = s.codec.extract(s.comp, s._qf_arr(), q=s._q_arr()) / 255.0
    return torch.clamp(img, 0, 1)[0].cpu().numpy()


def _polygon_mask(points, shape):
    """Scanline polygon fill (the GUI's poly region tool, GUI.py:565-614)
    without any imaging dependency."""
    h, w = shape
    pts = np.asarray(points, np.float64)  # [(y, x), ...]
    mask = np.zeros((h, w), np.float32)
    n = len(pts)
    for y in range(h):
        yc = y + 0.5
        xs = []
        for i in range(n):
            y0, x0 = pts[i]
            y1, x1 = pts[(i + 1) % n]
            if (y0 <= yc < y1) or (y1 <= yc < y0):
                xs.append(x0 + (yc - y0) / (y1 - y0) * (x1 - x0))
        for a, b in zip(*(iter(sorted(xs)),) * 2):
            mask[y, int(np.ceil(a - 0.5)):int(np.ceil(b - 0.5))] = 1.0
    return mask


PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>exsr — explorable SR</title>
<style>
 body { font-family: sans-serif; margin: 1em; background: #16181c;
        color: #dde; }
 #board { display: flex; gap: 1em; }
 canvas { border: 1px solid #555; image-rendering: pixelated; }
 button, select, input { margin: 2px; background: #2a2e36; color: #dde;
        border: 1px solid #555; border-radius: 4px; padding: 4px 8px; }
 #log { white-space: pre-wrap; font-family: monospace; font-size: 12px;
        max-height: 14em; overflow-y: auto; }
 .row { margin: 6px 0; }
 label { margin-right: 4px; }
</style></head><body>
<h3>exsr — explorable super-resolution</h3>
<div id="board">
 <div>
  <canvas id="cv" width="512" height="512"></canvas>
  <div class="row">view:
   <select id="view"><option>sr</option><option>lr</option>
    <option>gt</option><option>z</option><option>esrgan</option></select>
   <button onclick="refresh()">refresh</button>
   <label><input type="checkbox" id="selmode" checked>select region</label>
   <label><input type="checkbox" id="polymode">poly</label>
   <button onclick="api('clear_region',{})">clear region</button>
   <button onclick="api('invert_region',{}).then(refresh)">invert</button>
  </div>
 </div>
 <div style="max-width:430px">
  <div class="row"><input type="file" id="file">
   <label><input type="checkbox" id="ishr" checked>input is HR</label></div>
  <div class="row">
   <button onclick="optimize('l1')">sharpen-to-desired (l1)</button>
   <button onclick="optimize('max_STD')">increase variance</button>
   <button onclick="optimize('min_STD')">decrease variance</button>
   <button onclick="optimize('random_l1')">random alternative</button>
  </div>
  <div class="row" id="altrow">alts
   <input id="nalts" value="3" size="2">
   <button onclick="optimizeAlts()">random alternatives</button>
   <button onclick="altView(-1)">&lt;</button>
   <button onclick="altView(1)">&gt;</button>
   <button onclick="altCopy()">adopt</button>
   <button onclick="api('alternative',{push:true}).then(
     () => log('pushed current Z into alternatives'))">push</button></div>
  <div class="row">budget s <input id="budget" value="8" size="3">
   objective <input id="obj" value="l1" size="12">
   <button onclick="optimize(document.getElementById('obj').value)">run
   </button></div>
  <div class="row" id="svdrow">&lambda;0 <input type="range" id="l0" min="0" max="1"
    step="0.05" value="0.5" style="width:80px">
   &lambda;1 <input type="range" id="l1" min="0" max="1" step="0.05"
    value="0.5" style="width:80px">
   &theta; <input type="range" id="th" min="0" max="6.28" step="0.1"
    value="0" style="width:80px">
   <button onclick="svd()">apply SVD Z</button></div>
  <div class="row" id="scribblerow">
   <label><input type="checkbox" id="paintmode">scribble</label>
   <select id="sshape"><option>brush</option><option>line</option>
    <option>rect</option><option>ellipse</option></select>
   class <select id="sclass"><option value="1">color</option>
    <option value="2">brighten</option><option value="3">darken</option>
    <option value="4">TV region</option></select>
   <input type="color" id="scolor" value="#ff0000">
   width <input id="swidth" value="3" size="2">
   <button onclick="undoScribble()">undo stroke</button>
   <button onclick="clearScribble()">clear</button>
   <button onclick="runScribble()">run scribble</button></div>
  <div class="row" id="imprintrow">imprint:
   <input type="file" id="impfile">
   <label><input type="checkbox" id="impauto">auto-locate</label>
   <label><input type="checkbox" id="imptrans">transparent bg</label>
   <button onclick="doImprint(false)">place in region</button>
   <button onclick="doImprint(true)">find location</button></div>
  <div class="row" id="hsvrow">hue <input type="range" id="hue"
    min="-180" max="180" step="5" value="0" style="width:70px">
   sat <input type="range" id="sat" min="0" max="2" step="0.1" value="1"
    style="width:70px">
   val <input type="range" id="val" min="0" max="2" step="0.1" value="1"
    style="width:70px">
   <button onclick="hsvEdit()">apply HSV</button></div>
  <div class="row" id="digitrow">digit
   <input id="digitn" value="3" size="2">
   <button onclick="digitEdit()">resemble digit</button>
   <button onclick="digitAuto()" id="digitauto" style="display:none">
    auto explore</button></div>
  <div class="row">
   <button onclick="api('undo',{}).then(refresh)">undo</button>
   <button onclick="api('redo',{}).then(refresh)">redo</button>
   <button onclick="api('save_z',{path:'session_z.npz'})">save Z</button>
   <button onclick="api('load_z',{path:'session_z.npz'}).then(refresh)">
    load Z</button>
   <button onclick="api('save_outputs',{path:'session'}).then(
     j => log(j.error || ('saved ' + j.out + (j.z ? ' + ' + j.z : ''))))">
    save PNGs</button></div>
  <div class="row" id="kernelrow">kernel:
   <button onclick="api('kernel',{kind:'bicubic'}).then(refresh)">bicubic
   </button>
   <button onclick="api('kernel',{kind:'blurry_cubic_1.0'}).then(refresh)">
    blurry</button>
   <button onclick="api('kernel',{kind:'estimate'}).then(refresh)">
    KernelGAN estimate</button></div>
  <div id="log"></div>
 </div>
</div>
<script>
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
(async () => {  // adapt controls to the served session kind
 const st = await api('state', {});
 if (st.mode === 'jpeg') {
  document.getElementById('view').innerHTML =
   '<option>rgb</option><option>out</option><option>input</option>' +
   '<option>z</option>';
  document.getElementById('svdrow').style.display = 'none';
  document.getElementById('kernelrow').style.display = 'none';
  document.getElementById('impauto').parentElement.style.display = 'none';
  document.getElementById('digitauto').style.display = '';
  document.querySelector('h3').textContent =
   'exsr — explorable JPEG decoding (QF ' + st.qf + ')';
 }
})();
let imgW = 0, imgH = 0, drag = null, rect = null;
function log(s) { const el = document.getElementById('log');
 el.textContent += s + "\\n"; el.scrollTop = el.scrollHeight; }
async function api(name, body) {
 const r = await fetch('/api/' + name, {method: 'POST',
   headers: {'Content-Type': 'application/json'},
   body: JSON.stringify(body || {})});
 const j = await r.json();
 if (j.error) log('ERR ' + name + ': ' + j.error);
 return j;
}
async function refresh() {
 const which = document.getElementById('view').value;
 const j = await api('view', {which});
 if (!j.png) return;
 const im = new Image();
 im.onload = () => { imgW = im.width; imgH = im.height;
  cv.width = im.width; cv.height = im.height;
  ctx.drawImage(im, 0, 0);
  if (scv.width === imgW && scv.height === imgH)
   ctx.drawImage(scv, 0, 0);
  if (rect) { ctx.strokeStyle = '#3df'; ctx.setLineDash([4, 3]);
   ctx.strokeRect(rect[1], rect[0], rect[3] - rect[1], rect[2] - rect[0]); }
 };
 im.src = 'data:image/png;base64,' + j.png;
}
document.getElementById('file').onchange = (e) => {
 const f = e.target.files[0]; if (!f) return;
 const rd = new FileReader();
 rd.onload = async () => {
  log('opening image...');
  const j = await api('open', {image: rd.result,
    is_hr: document.getElementById('ishr').checked});
  log('opened: ' + JSON.stringify(j.sr_shape || j.out_shape) +
      (j.source ? ' (' + j.source + ')' : '')); rect = null;
  sUndo.length = 0; altCount = 0; polyPts = [];   // previous-image state
  if (sctx) { sctx.clearRect(0, 0, scv.width, scv.height);
              mctx.clearRect(0, 0, mcv.width, mcv.height); }
  refresh();
 };
 rd.readAsDataURL(f);
};
// ---- scribble authoring: color strokes + a 3-state/TV class mask
// (the GUI's pencil tools with color cycling, GUI.py:640-855) ----
const scv = document.createElement('canvas');   // visible strokes
const mcv = document.createElement('canvas');   // class mask (red ch.)
let sctx = null, mctx = null, painting = false, tvNext = 4, tvCur = 4;
function ensureScribble() {
 if (scv.width !== imgW || scv.height !== imgH) {
  scv.width = mcv.width = imgW; scv.height = mcv.height = imgH;
  sctx = mctx = null;
  sUndo.length = 0;    // snapshots belong to the previous image/size
 }
 if (!sctx) { sctx = scv.getContext('2d'); mctx = mcv.getContext('2d'); }
}
function clearScribble() {
 ensureScribble(); sctx.clearRect(0, 0, imgW, imgH);
 mctx.clearRect(0, 0, imgW, imgH); tvNext = 4; sUndo.length = 0;
 refresh();
}
// stroke-level undo (the GUI's undo_scribble_button, GUI.py:272-300)
const sUndo = [];
function snapScribble() {
 ensureScribble();
 if (sUndo.length > 19) sUndo.shift();
 sUndo.push([sctx.getImageData(0, 0, imgW, imgH),
             mctx.getImageData(0, 0, imgW, imgH)]);
}
function undoScribble() {
 if (!sUndo.length) return;
 ensureScribble();
 const [a, b] = sUndo.pop();
 sctx.putImageData(a, 0, 0); mctx.putImageData(b, 0, 0); refresh();
}
function classColors() {
 let cls = document.getElementById('sclass').value;
 if (cls === '4') cls = String(tvCur);
 const colors = {2: '#ffffff', 3: '#000000'};
 const vis = colors[cls] || document.getElementById('scolor').value;
 const v = parseInt(cls) * 16;  // wide buckets: AA-proof class encoding
 return [vis, 'rgb(' + v + ',' + v + ',' + v + ')'];
}
function paintAt(y, x) {
 ensureScribble();
 const w = parseInt(document.getElementById('swidth').value) || 3;
 const [vis, mcol] = classColors();
 sctx.fillStyle = vis;
 sctx.beginPath(); sctx.arc(x, y, w, 0, 6.3); sctx.fill();
 mctx.fillStyle = mcol;
 mctx.beginPath(); mctx.arc(x, y, w, 0, 6.3); mctx.fill();
 ctx.drawImage(scv, 0, 0);
}
// line/rect/ellipse scribble shapes (the GUI's shape tools,
// GUI.py:640-855), stroked into both the visible and the class canvas
let shapeStart = null;
function drawShape(y0, x0, y1, x1) {
 ensureScribble();
 const w = parseInt(document.getElementById('swidth').value) || 3;
 const shape = document.getElementById('sshape').value;
 const cols = classColors();
 [[sctx, cols[0]], [mctx, cols[1]]].forEach(([c, col]) => {
  c.strokeStyle = col; c.lineWidth = 2 * w; c.beginPath();
  if (shape === 'line') { c.moveTo(x0, y0); c.lineTo(x1, y1); }
  else if (shape === 'rect')
   c.rect(Math.min(x0, x1), Math.min(y0, y1),
          Math.abs(x1 - x0), Math.abs(y1 - y0));
  else c.ellipse((x0 + x1) / 2, (y0 + y1) / 2, Math.abs(x1 - x0) / 2,
                 Math.abs(y1 - y0) / 2, 0, 0, 6.3);
  c.stroke();
 });
 ctx.drawImage(scv, 0, 0);
}
async function runScribble() {
 ensureScribble();
 const st = await api('state', {});
 const j = await api('view',
   {which: st.mode === 'jpeg' ? 'out' : 'sr'});
 if (!j.png) return;
 const im = new Image();
 await new Promise(r => { im.onload = r;
  im.src = 'data:image/png;base64,' + j.png; });
 const d = document.createElement('canvas');
 d.width = imgW; d.height = imgH;
 const dx = d.getContext('2d');
 dx.drawImage(im, 0, 0); dx.drawImage(scv, 0, 0);
 log('optimizing scribble...');
 const r = await api('optimize', {objective: 'scribble',
   time_budget_s: parseFloat(document.getElementById('budget').value),
   data: {desired: d.toDataURL('image/png'),
          scribble_mask: mcv.toDataURL('image/png'),
          brightness_factor: 0.3}});
 log('scribble done: loss ' + (r.final_loss || 0).toFixed(5));
 refresh();
}
function doImprint(findOnly) {
 const f = document.getElementById('impfile').files[0];
 if (!f) { log('choose an imprint image first'); return; }
 const rd = new FileReader();
 rd.onload = async () => {
  const body = {image: rd.result};
  if (rect) {
   body.size = [rect[2] - rect[0], rect[3] - rect[1]];
   body.search_rect = rect;
   body.position = [rect[0], rect[1]];
  }
  if (findOnly) {
   const j = await api('find_imprint_location', body);
   if (j.position) {
    log('best location ' + j.position + ' (err '
        + j.consistency_error.toFixed(5) + ')');
    if (body.size) rect = [j.position[0], j.position[1],
      j.position[0] + body.size[0], j.position[1] + body.size[1]];
   }
   refresh(); return;
  }
  if (document.getElementById('impauto').checked) {
   body.auto = true; delete body.position;
  }
  if (document.getElementById('imptrans').checked) body.transparent = true;
  log('imprinting...');
  const j = await api('imprint', body);
  if (j.position) log('imprinted at ' + j.position + ', loss '
      + (j.final_loss || 0).toFixed(5));
  refresh();
 };
 rd.readAsDataURL(f);
}
async function hsvEdit() {
 log('HSV edit...');
 const j = await api('hsv', {
   hue_shift: parseFloat(document.getElementById('hue').value),
   sat: parseFloat(document.getElementById('sat').value),
   val: parseFloat(document.getElementById('val').value)});
 if (j.final_loss !== undefined)
  log('HSV done: loss ' + (j.final_loss || 0).toFixed(5));
 refresh();
}
async function digitEdit() {
 log('digit...');
 const j = await api('digit', {
   digit: parseInt(document.getElementById('digitn').value) || 0,
   time_budget_s: parseFloat(document.getElementById('budget').value)});
 if (j.final_loss !== undefined)
  log('digit done: loss ' + (j.final_loss || 0).toFixed(5));
 refresh();
}
async function digitAuto() {
 log('auto-exploring digits 0-9...');
 const j = await api('digit', {auto: true});
 if (j.most_likely !== undefined)
  log('most likely digit: ' + j.most_likely +
      (j.prob ? ' (p=' + j.prob.toFixed(3) + ')' : ''));
 refresh();
}
// ---- polygon region selection (the GUI's poly tool, GUI.py:565-614):
// click to add vertices, double-click to close ----
let polyPts = [];
cv.ondblclick = async (e) => {
 if (!document.getElementById('polymode').checked || polyPts.length < 3)
  return;
 const j = await api('region', {polygon: polyPts});
 log('poly region: ' + j.selected_px + ' px');
 polyPts = []; rect = null; refresh();
};
cv.onmousedown = (e) => {
 shapeStart = null;   // a drag released off-canvas must not leak here
 const b = cv.getBoundingClientRect();
 const y = e.clientY - b.top, x = e.clientX - b.left;
 if (document.getElementById('polymode').checked &&
     document.getElementById('selmode').checked &&
     !document.getElementById('paintmode').checked) {
  polyPts.push([Math.round(y), Math.round(x)]);
  ctx.fillStyle = '#3df';
  ctx.fillRect(x - 2, y - 2, 4, 4);
  if (polyPts.length > 1) {
   const p = polyPts[polyPts.length - 2];
   ctx.strokeStyle = '#3df'; ctx.setLineDash([4, 3]);
   ctx.beginPath(); ctx.moveTo(p[1], p[0]); ctx.lineTo(x, y);
   ctx.stroke();
  }
  return;
 }
 if (document.getElementById('paintmode').checked) {
  if (document.getElementById('sclass').value === '4') {
   tvCur = tvNext;                     // ids 4..15 fit the 16-wide buckets
   tvNext = tvNext >= 15 ? 4 : tvNext + 1;
  }
  snapScribble();
  if (document.getElementById('sshape').value !== 'brush') {
   shapeStart = [y, x]; return;
  }
  painting = true; paintAt(y, x); return;
 }
 if (!document.getElementById('selmode').checked) return;
 drag = [y, x];
};
cv.onmousemove = (e) => {
 if (!painting) return;
 const b = cv.getBoundingClientRect();
 paintAt(e.clientY - b.top, e.clientX - b.left);
};
cv.onmouseup = async (e) => {
 if (shapeStart) {
  const b = cv.getBoundingClientRect();
  drawShape(shapeStart[0], shapeStart[1],
            e.clientY - b.top, e.clientX - b.left);
  shapeStart = null; return;
 }
 if (painting) { painting = false; return; }
 if (!drag) return;
 const b = cv.getBoundingClientRect();
 const y1 = e.clientY - b.top, x1 = e.clientX - b.left;
 rect = [Math.min(drag[0], y1), Math.min(drag[1], x1),
         Math.max(drag[0], y1), Math.max(drag[1], x1)].map(Math.round);
 drag = null;
 const j = await api('region', {rect});
 log('region: ' + j.selected_px + ' px'); refresh();
};
async function optimize(objective) {
 log('optimizing ' + objective + '...');
 const j = await api('optimize', {objective,
   time_budget_s: parseFloat(document.getElementById('budget').value)});
 log('done: loss ' + (j.final_loss || 0).toFixed(5) + ' after '
     + j.rounds + ' rounds');
 refresh();
}
// ---- random-alternative browsing (random_Zs flow, GUI.py:1420,1740) ----
let altIdx = 0, altCount = 0;
async function optimizeAlts() {
 const n = parseInt(document.getElementById('nalts').value) || 3;
 log('optimizing ' + n + ' random alternatives...');
 const j = await api('optimize', {objective: 'random_l1',
   n_alternatives: n + 1,
   time_budget_s: parseFloat(document.getElementById('budget').value)});
 altCount = j.n_alternatives || 0; altIdx = 0;
 log('done: ' + altCount + ' alternatives retained');
 refresh();
}
async function altView(d) {
 if (!altCount) { log('no alternatives - run random alternatives first');
  return; }
 altIdx = ((altIdx + d) % altCount + altCount) % altCount;
 const j = await api('alternative', {index: altIdx});
 if (!j.png) return;
 const im = new Image();
 im.onload = () => { ctx.drawImage(im, 0, 0); };
 im.src = 'data:image/png;base64,' + j.png;
 log('alternative ' + (altIdx + 1) + '/' + altCount);
}
async function altCopy() {
 if (!altCount) return;
 await api('alternative', {index: altIdx, copy: true});
 log('adopted alternative ' + (altIdx + 1)); refresh();
}
async function svd() {
 await api('svd', {lambda0: parseFloat(document.getElementById('l0').value),
   lambda1: parseFloat(document.getElementById('l1').value),
   theta: parseFloat(document.getElementById('th').value)});
 refresh();
}
api('state', {}).then(j => { if (j.has_image) refresh(); });
</script></body></html>
"""


def make_server(api: SessionApi, port: int = 8000,
                host: str = '127.0.0.1') -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body: bytes, ctype='application/json'):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ('/', '/index.html'):
                self._send(200, PAGE.encode(), 'text/html; charset=utf-8')
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if not self.path.startswith('/api/'):
                self._send(404, b'{"error": "not found"}')
                return
            n = int(self.headers.get('Content-Length', 0))
            try:
                req = json.loads(self.rfile.read(n) or b'{}')
                out = api.dispatch(self.path[len('/api/'):], req)
            except Exception as e:  # surfaced to the client, like the
                out = {'error': f'{type(e).__name__}: {e}'}  # GUI statusbar
            self._send(200, json.dumps(out).encode())

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.api = api   # introspection for tests / callers
    return srv


def _gui_options(args, argv):
    """``--opt``'s values filled into ``args`` where no flag gave them;
    returns ``(jpeg latent channels, chroma architecture)``."""
    jpeg_latent, chroma_arch = 64, {}
    if not args.opt:
        return jpeg_latent, chroma_arch
    import sys
    from exsr_torch.options.config import num_latent_channels
    from exsr_torch.options.config import parse as parse_opt
    o = parse_opt(args.opt, is_train=False)
    given = {a[2:].split('=')[0]
             for a in (argv if argv is not None else sys.argv[1:])
             if a.startswith('--')}
    g_opt = dict(o['network_G'] or {})
    if 'mode' not in given and (o['model'] == 'dncnn' or g_opt.get('DCT_G')):
        args.mode = 'jpeg'
    if args.mode == 'jpeg':
        # in the JPEG GUI config network_G describes the chroma net; the Y
        # generator (the one the session edits) is network_G overridden by
        # network_G_Y
        chroma_arch = {k: g_opt[k] for k in ('nf', 'nb') if g_opt.get(k)}
        y_over = o['network_G_Y']
        if y_over:
            g_opt.update({k: v for k, v in dict(y_over).items()
                          if v is not None})
    if 'scale' not in given and o['scale']:
        args.scale = int(o['scale'])
    if args.nb is None and g_opt.get('nb'):
        args.nb = int(g_opt['nb'])
    if args.nf is None and g_opt.get('nf'):
        args.nf = int(g_opt['nf'])
    if g_opt.get('latent_channels'):
        jpeg_latent = num_latent_channels(g_opt['latent_channels'])
    return jpeg_latent, chroma_arch


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return (np.asarray(im.convert('RGB')) / 255.0).astype(np.float32)


def main(argv=None, serve: bool = True):
    """Build the session and its server; serve until interrupted, or,
    with ``serve=False``, return the server unstarted (its ``api``
    attribute is the :class:`SessionApi`)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--port', type=int, default=8000)
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--opt',
                   help='reference GUI options JSON (GUI_SR.json / '
                        'GUI_JPEG.json dialect): fills mode, scale, nb, nf '
                        'and the latent channels; explicit flags win')
    p.add_argument('--scale', type=int, default=4)
    p.add_argument('--nb', type=int, default=None,
                   help='generator depth (default: 23 SR / 10 JPEG)')
    p.add_argument('--nf', type=int, default=None,
                   help='generator width (JPEG mode; default 320)')
    p.add_argument('--checkpoint',
                   help="generator weights: a directory of the port's "
                        "checkpoints (its 'g_params'; scripts "
                        'convert_torch_g writes one from a reference .pth) '
                        'or an exsr generator exported as .npz')
    p.add_argument('--image', help='image to open at startup')
    p.add_argument('--time_budget', type=float, default=30.0)
    p.add_argument('--mode', choices=['sr', 'jpeg'], default='sr',
                   help="'jpeg' serves a JPEGEditSession (Y-channel "
                        'artifact editing) instead of the SR session')
    p.add_argument('--qf', type=int, default=10,
                   help='JPEG quality factor (jpeg mode)')
    p.add_argument('--chroma_checkpoint',
                   help="trained chroma generator (a directory of the "
                        "port's train_jpeg --chroma checkpoints, or .npz) "
                        "for the JPEG mode's colour view")
    p.add_argument('--chroma_nf', type=int, default=None,
                   help="chroma generator width (default: the --opt "
                        "config's network_G nf, else 320)")
    p.add_argument('--chroma_nb', type=int, default=None,
                   help='chroma generator depth (default: config, else 10)')
    p.add_argument('--esrgan', action='store_true',
                   help='serve the plain-ESRGAN comparison view')
    p.add_argument('--esrgan_checkpoint',
                   help='converted plain-ESRGAN weights (scripts '
                        'convert_torch_g --latent_channels 0); seeded '
                        'random weights when omitted')
    p.add_argument('--device', default=None,
                   help='torch device (default: the current CUDA device); '
                        "'cpu' runs on the CPU")
    args = p.parse_args(argv)
    jpeg_latent, chroma_arch = _gui_options(args, argv)

    if args.mode == 'jpeg':
        from exsr_torch.apps.eval_jpeg import load_generator_params
        from exsr_torch.apps.jpeg_session import JPEGEditSession
        session = JPEGEditSession(qf=args.qf, nf=args.nf or 320,
                                  nb=args.nb or 10,
                                  latent_channels=jpeg_latent,
                                  time_budget_s=args.time_budget,
                                  device=args.device)
        if args.checkpoint:
            session.load_params(load_generator_params(args.checkpoint))
        else:
            session.init_random_params(0)
        if args.chroma_checkpoint:
            session.attach_chroma(
                load_generator_params(args.chroma_checkpoint),
                nf=args.chroma_nf or int(chroma_arch.get('nf', 320)),
                nb=args.chroma_nb or int(chroma_arch.get('nb', 10)))
        if args.image:
            session.open_image(_read_rgb(args.image))
        api = JpegSessionApi(session)
        srv = make_server(api, args.port, args.host)
        print(f'exsr_torch web UI (JPEG mode) at '
              f'http://{args.host}:{srv.server_address[1]}/')
    else:
        from exsr_torch.apps.eval_sr import load_generator_params
        from exsr_torch.apps.session import EditSession
        sr_nb = args.nb or 23
        session = EditSession(scale=args.scale, nb=sr_nb,
                              time_budget_s=args.time_budget,
                              device=args.device)
        if args.checkpoint:
            session.load_params(load_generator_params(args.checkpoint))
        else:
            session.init_random_params(0)
        if args.esrgan or args.esrgan_checkpoint:
            session.attach_esrgan(
                load_generator_params(args.esrgan_checkpoint)
                if args.esrgan_checkpoint else None)
        if args.image:
            session.open_image(_read_rgb(args.image), is_hr=True)
        api = SessionApi(session)
        srv = make_server(api, args.port, args.host)
        print(f'exsr_torch web UI at '
              f'http://{args.host}:{srv.server_address[1]}/')
    if serve:
        try:
            srv.serve_forever()
        finally:
            srv.server_close()
    return srv


if __name__ == '__main__':
    main()
