/* Threaded 2D volume resampler with scipy.ndimage.zoom semantics.
 *
 * The eval protocol (utils.py:63-88 of the reference) resamples every CT
 * slice 512->224 with an order-3 B-spline and maps predictions back
 * 224->512 with order-0 — on the host this dominates per-volume latency
 * (3.4s/volume vs ~5ms of TPU compute). This implements both orders with
 * scipy's conventions (coordinate = i*(in-1)/(out-1), mirror-boundary
 * cubic prefilter, constant/cval=0 out-of-range taps, round-half-up for
 * order 0), parallelized over slices with pthreads.
 *
 * A copy of transception_tpu/native/resample.c for the PyTorch port: built
 * by transception_tpu_torch/native/__init__.py (cc -O3 -shared, into
 * transception_tpu_torch/build/) and loaded via ctypes; a failed build
 * raises with the compiler's output.
 */

#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define POLE (-0.26794919243112270647) /* sqrt(3) - 2, cubic B-spline */

static inline int64_t mirror_index(int64_t k, int64_t n) {
    /* scipy 'mirror': reflect about the end samples (period 2n-2). */
    if (n == 1) return 0;
    int64_t p = 2 * (n - 1);
    k = llabs(k) % p;
    return k < n ? k : p - k;
}

/* In-place cubic B-spline prefilter along a contiguous line. */
static void spline_filter_line(double *c, int64_t n) {
    if (n < 2) return;
    const double z = POLE;
    const double gain = (1.0 - z) * (1.0 - 1.0 / z);
    for (int64_t i = 0; i < n; i++) c[i] *= gain;
    /* causal init: truncated z-transform sum over the mirrored signal. */
    int64_t horizon = (int64_t)(ceil(log(1e-15) / log(fabs(z))));
    if (horizon > 2 * (n - 1)) horizon = 2 * (n - 1);
    double sum = c[0];
    double zn = z;
    for (int64_t k = 1; k <= horizon; k++) {
        sum += zn * c[mirror_index(k, n)];
        zn *= z;
    }
    c[0] = sum;
    for (int64_t i = 1; i < n; i++) c[i] += z * c[i - 1];
    /* anticausal init (mirror). */
    c[n - 1] = (z / (z * z - 1.0)) * (z * c[n - 2] + c[n - 1]);
    for (int64_t i = n - 2; i >= 0; i--) c[i] = z * (c[i + 1] - c[i]);
}

static inline void cubic_weights(double t, double *w) {
    const double t2 = t * t, t3 = t2 * t;
    w[0] = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0;
    w[1] = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0;
    w[2] = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0;
    w[3] = t3 / 6.0;
}

typedef struct {
    const float *in;
    float *out;
    int64_t d, h, w, oh, ow;
    int order;
    int64_t slice_begin, slice_end;
    /* precomputed per-output-coordinate taps/weights (order 3) or
       indices (order 0) */
    const int64_t *ybase;
    const double *ywts;
    const int64_t *xbase;
    const double *xwts;
    const int64_t *yidx0;
    const int64_t *xidx0;
    int rc; /* set to -1 by the worker on allocation failure */
} job_t;

static void zoom_slice_cubic(const job_t *jb, const float *src, float *dst,
                             double *coef, double *line) {
    const int64_t h = jb->h, w = jb->w, oh = jb->oh, ow = jb->ow;
    /* prefilter: rows then columns, double precision. */
    for (int64_t y = 0; y < h; y++) {
        for (int64_t x = 0; x < w; x++) line[x] = (double)src[y * w + x];
        spline_filter_line(line, w);
        memcpy(coef + y * w, line, (size_t)w * sizeof(double));
    }
    double *col = line; /* reuse, w >= h not guaranteed; allocate max */
    for (int64_t x = 0; x < w; x++) {
        for (int64_t y = 0; y < h; y++) col[y] = coef[y * w + x];
        spline_filter_line(col, h);
        for (int64_t y = 0; y < h; y++) coef[y * w + x] = col[y];
    }
    for (int64_t oy = 0; oy < oh; oy++) {
        const int64_t yb = jb->ybase[oy];
        const double *wy = jb->ywts + 4 * oy;
        /* scipy: coordinates outside [0, n-1] yield cval (and its
           k/zoom rounding puts the last output exactly out of range for
           many sizes — reproduced via the precomputed base of -2). */
        if (yb == INT64_MIN) {
            for (int64_t ox = 0; ox < ow; ox++) dst[oy * ow + ox] = 0.0f;
            continue;
        }
        for (int64_t ox = 0; ox < ow; ox++) {
            const int64_t xb = jb->xbase[ox];
            if (xb == INT64_MIN) {
                dst[oy * ow + ox] = 0.0f;
                continue;
            }
            const double *wx = jb->xwts + 4 * ox;
            double acc = 0.0;
            for (int i = 0; i < 4; i++) {
                /* in-range coordinate: edge taps mirror-extend the
                   coefficient array (scipy eval semantics). */
                const double *row = coef + mirror_index(yb + i - 1, h) * w;
                double racc = 0.0;
                for (int j = 0; j < 4; j++)
                    racc += wx[j] * row[mirror_index(xb + j - 1, w)];
                acc += wy[i] * racc;
            }
            dst[oy * ow + ox] = (float)acc;
        }
    }
}

static void *worker(void *arg) {
    job_t *jb = (job_t *)arg;
    const int64_t h = jb->h, w = jb->w, oh = jb->oh, ow = jb->ow;
    if (jb->order == 3) {
        double *coef = (double *)malloc((size_t)(h * w) * sizeof(double));
        int64_t lmax = h > w ? h : w;
        double *line = (double *)malloc((size_t)lmax * sizeof(double));
        if (coef == NULL || line == NULL) {
            free(coef);
            free(line);
            jb->rc = -1;
            return NULL;
        }
        for (int64_t s = jb->slice_begin; s < jb->slice_end; s++)
            zoom_slice_cubic(jb, jb->in + s * h * w, jb->out + s * oh * ow,
                             coef, line);
        free(coef);
        free(line);
    } else { /* order 0 */
        for (int64_t s = jb->slice_begin; s < jb->slice_end; s++) {
            const float *src = jb->in + s * h * w;
            float *dst = jb->out + s * oh * ow;
            for (int64_t oy = 0; oy < oh; oy++) {
                if (jb->yidx0[oy] == INT64_MIN) {
                    for (int64_t ox = 0; ox < ow; ox++)
                        dst[oy * ow + ox] = 0.0f;
                    continue;
                }
                const float *row = src + jb->yidx0[oy] * w;
                for (int64_t ox = 0; ox < ow; ox++)
                    dst[oy * ow + ox] =
                        jb->xidx0[ox] == INT64_MIN ? 0.0f : row[jb->xidx0[ox]];
            }
        }
    }
    return NULL;
}

/* Public entry: float32 (d, h, w) -> (d, oh, ow), order 0 or 3. */
int zoom2d_batch_f32(const float *in, int64_t d, int64_t h, int64_t w,
                     float *out, int64_t oh, int64_t ow, int order,
                     int nthreads) {
    if (order != 0 && order != 3) return -1;
    if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0) return -1;
    if (d <= 0) return 0; /* nothing to do; avoids nthreads clamping to 0 */
    if (nthreads < 1) nthreads = 1;
    if (nthreads > d) nthreads = (int)d;

    /* Precompute output->input coordinate taps. scipy (grid_mode=False)
       precomputes zoom = (in-1)/(out-1) in double and uses coord = i*zoom —
       that exact rounding is part of the protocol (e.g. 512->224 puts the
       last output just past in-1, yielding a cval row). Reproduced. */
    int64_t *ybase = NULL, *xbase = NULL, *yidx0 = NULL, *xidx0 = NULL;
    double *ywts = NULL, *xwts = NULL;
    const double zy = (h > 1 && oh > 1)
        ? (double)(h - 1) / (double)(oh - 1) : 1.0;
    const double zx = (w > 1 && ow > 1)
        ? (double)(w - 1) / (double)(ow - 1) : 1.0;
    if (order == 3) {
        ybase = malloc((size_t)oh * sizeof(int64_t));
        xbase = malloc((size_t)ow * sizeof(int64_t));
        ywts = malloc((size_t)(4 * oh) * sizeof(double));
        xwts = malloc((size_t)(4 * ow) * sizeof(double));
        if (!ybase || !xbase || !ywts || !xwts) {
            free(ybase); free(xbase); free(ywts); free(xwts);
            return -1;
        }
        for (int64_t i = 0; i < oh; i++) {
            double c = (double)i * zy;
            if (c < 0.0 || c > (double)(h - 1)) {
                ybase[i] = INT64_MIN; /* out of range -> cval */
                memset(ywts + 4 * i, 0, 4 * sizeof(double));
                continue;
            }
            int64_t b = (int64_t)floor(c);
            ybase[i] = b;
            cubic_weights(c - b, ywts + 4 * i);
        }
        for (int64_t i = 0; i < ow; i++) {
            double c = (double)i * zx;
            if (c < 0.0 || c > (double)(w - 1)) {
                xbase[i] = INT64_MIN;
                memset(xwts + 4 * i, 0, 4 * sizeof(double));
                continue;
            }
            int64_t b = (int64_t)floor(c);
            xbase[i] = b;
            cubic_weights(c - b, xwts + 4 * i);
        }
    } else {
        yidx0 = malloc((size_t)oh * sizeof(int64_t));
        xidx0 = malloc((size_t)ow * sizeof(int64_t));
        if (!yidx0 || !xidx0) {
            free(yidx0); free(xidx0);
            return -1;
        }
        for (int64_t i = 0; i < oh; i++) {
            double c = (double)i * zy;
            if (c < 0.0 || c > (double)(h - 1)) { yidx0[i] = INT64_MIN; continue; }
            int64_t k = (int64_t)floor(c + 0.5);
            yidx0[i] = k > h - 1 ? h - 1 : k;
        }
        for (int64_t i = 0; i < ow; i++) {
            double c = (double)i * zx;
            if (c < 0.0 || c > (double)(w - 1)) { xidx0[i] = INT64_MIN; continue; }
            int64_t k = (int64_t)floor(c + 0.5);
            xidx0[i] = k > w - 1 ? w - 1 : k;
        }
    }

    pthread_t threads[256];
    job_t jobs[256];
    if (nthreads > 256) nthreads = 256;
    int64_t per = (d + nthreads - 1) / nthreads;
    int nt = 0;
    for (int t = 0; t < nthreads; t++) {
        int64_t b = t * per, e = b + per;
        if (b >= d) break;
        if (e > d) e = d;
        jobs[nt] = (job_t){in, out, d, h, w, oh, ow, order, b, e,
                           ybase, ywts, xbase, xwts, yidx0, xidx0, 0};
        pthread_create(&threads[nt], NULL, worker, &jobs[nt]);
        nt++;
    }
    int rc = 0;
    for (int t = 0; t < nt; t++) {
        pthread_join(threads[t], NULL);
        if (jobs[t].rc != 0) rc = -1;
    }

    free(ybase); free(xbase); free(ywts); free(xwts);
    free(yidx0); free(xidx0);
    return rc;
}
