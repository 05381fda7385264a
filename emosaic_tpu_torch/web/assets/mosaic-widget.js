/*
 * Mosaic widget frontend.
 *
 * Feature surface (matching the reference widget's src/assets/mosaic-widget.js):
 *  - zoom/pan engine: pinch zoom (0.5x-5x) with pan constraints, double-tap
 *    reset on touch devices, wheel zoom on desktop;
 *  - distance overlay toggle driven by a postMessage protocol with the
 *    wrapping main page ({type:'toggleDistanceOverlay'} in,
 *    {type:'distanceOverlayToggled', visible} out);
 *  - tile tooltips with lazy preview-image loading and edge-aware placement;
 *  - tile click: new tab on desktop, info modal on mobile;
 *  - year filter slider (max position = "All Years", other positions add
 *    .disabled to tiles from other years);
 *  - TileFlagSystem: client of the flag REST API (POST/DELETE
 *    /tiles/{hash}/flag, POST /tiles/flags) with a 10s response cache,
 *    request de-duplication, a localStorage fallback when no API is
 *    configured, and one-time localStorage -> server migration when an
 *    API appears (reference mosaic-widget.js:1127-1210 behavior);
 *    client-side rate limiter (10 flags/min sliding window);
 *  - mobile lifecycle: iOS Safari toolbar-hide attempt on load, debounced
 *    orientationchange/resize re-layout with fit-to-container minimum
 *    zoom on mobile (reference mosaic-widget.js:8-36, :505-560).
 *
 * The API base is read from window.MOSAIC_FLAG_API (set it in a <script>
 * tag before this file loads); without it, flags persist in localStorage.
 */
(function () {
  'use strict';

  var MAX_ZOOM = 5.0;
  var MOBILE_BREAKPOINT = 768;

  function isMobile() {
    return window.innerWidth <= MOBILE_BREAKPOINT || 'ontouchstart' in window;
  }

  function isIOS() {
    return /iPad|iPhone|iPod/.test(navigator.userAgent);
  }

  /* Attempt to hide the Safari toolbar on iOS: scroll trick after load,
   * plus standalone-mode detection (home-screen apps have none). */
  function attemptHideIOSToolbar() {
    if (!isIOS()) return;
    setTimeout(function () {
      window.scrollTo(0, 1);
    }, 100);
    if (!window.navigator.standalone && document.documentElement.requestFullscreen) {
      var once = function () {
        document.documentElement.requestFullscreen().catch(function () {});
        document.removeEventListener('touchstart', once);
      };
      document.addEventListener('touchstart', once, { once: true });
    }
  }

  /* ----------------------------------------------------------------- *
   * Zoom / pan engine
   * ----------------------------------------------------------------- */
  var zoom = {
    scale: 1,
    tx: 0,
    ty: 0,
    minZoom: 0.5,
    container: null,
    apply: function () {
      if (!this.container) return;
      this.clamp();
      this.container.style.transform =
        'translate(' + this.tx + 'px,' + this.ty + 'px) scale(' + this.scale + ')';
    },
    clamp: function () {
      this.scale = Math.min(MAX_ZOOM, Math.max(this.minZoom, this.scale));
      var rect = this.container.getBoundingClientRect();
      var parent = this.container.parentElement.getBoundingClientRect();
      var maxX = Math.max(0, (rect.width - parent.width) / 2 + 80);
      var maxY = Math.max(0, (rect.height - parent.height) / 2 + 80);
      this.tx = Math.min(maxX, Math.max(-maxX, this.tx));
      this.ty = Math.min(maxY, Math.max(-maxY, this.ty));
    },
    reset: function () {
      this.scale = isMobile() ? this.minZoom : 1;
      this.tx = 0;
      this.ty = 0;
      this.apply();
    },
    /* Mobile: the minimum zoom is "image fits the container" (with a 5%
     * buffer, capped at 1). Desktop keeps an effectively-free minimum. */
    updateMinZoom: function () {
      if (!this.container) return;
      if (!isMobile()) {
        this.minZoom = 0.1;
        return;
      }
      var img = this.container.querySelector('.mosaic-image');
      var parent = this.container.parentElement;
      if (!img || !parent || !img.naturalWidth || !img.naturalHeight) {
        this.minZoom = 0.5;
        return;
      }
      var p = parent.getBoundingClientRect();
      var fit = Math.min(
        p.width / img.naturalWidth,
        p.height / img.naturalHeight
      );
      this.minZoom = Math.min(fit * 0.95, 1);
      if (this.scale < this.minZoom) {
        this.scale = this.minZoom;
        this.apply();
      }
    },
  };

  function setupZoom() {
    var container = document.querySelector('.zoom-container');
    if (!container) return;
    zoom.container = container;

    // wheel zoom (desktop)
    container.parentElement.addEventListener(
      'wheel',
      function (e) {
        if (!e.ctrlKey && !e.metaKey) return;
        e.preventDefault();
        zoom.scale *= e.deltaY < 0 ? 1.1 : 0.9;
        zoom.apply();
      },
      { passive: false }
    );

    // touch: pinch + pan + double-tap reset
    var touches = {};
    var lastDist = null;
    var lastTap = 0;
    var panStart = null;

    container.addEventListener(
      'touchstart',
      function (e) {
        for (var i = 0; i < e.changedTouches.length; i++) {
          var t = e.changedTouches[i];
          touches[t.identifier] = { x: t.clientX, y: t.clientY };
        }
        if (e.touches.length === 1) {
          var now = Date.now();
          if (now - lastTap < 300) {
            zoom.reset();
            lastTap = 0;
          } else {
            lastTap = now;
          }
          panStart = {
            x: e.touches[0].clientX - zoom.tx,
            y: e.touches[0].clientY - zoom.ty,
          };
        }
      },
      { passive: true }
    );

    container.addEventListener(
      'touchmove',
      function (e) {
        if (e.touches.length === 2) {
          e.preventDefault();
          var dx = e.touches[0].clientX - e.touches[1].clientX;
          var dy = e.touches[0].clientY - e.touches[1].clientY;
          var dist = Math.sqrt(dx * dx + dy * dy);
          if (lastDist !== null) {
            zoom.scale *= dist / lastDist;
            zoom.apply();
          }
          lastDist = dist;
        } else if (e.touches.length === 1 && panStart && zoom.scale > 1) {
          e.preventDefault();
          zoom.tx = e.touches[0].clientX - panStart.x;
          zoom.ty = e.touches[0].clientY - panStart.y;
          zoom.apply();
        }
      },
      { passive: false }
    );

    container.addEventListener('touchend', function () {
      lastDist = null;
      panStart = null;
    });
  }

  /* ----------------------------------------------------------------- *
   * Resize / orientation lifecycle (debounced)
   * ----------------------------------------------------------------- */
  function repositionVisibleTooltips() {
    var regions = document.querySelectorAll('.tile-region:hover');
    for (var i = 0; i < regions.length; i++) positionTooltip(regions[i]);
  }

  function handleResize() {
    if (isMobile()) {
      zoom.updateMinZoom();
      zoom.apply(); // re-clamp pan for the new viewport
    } else {
      setTimeout(repositionVisibleTooltips, 10);
    }
  }

  var orientationTimer = null;
  function handleOrientationChange() {
    clearTimeout(orientationTimer);
    orientationTimer = setTimeout(function () {
      zoom.updateMinZoom();
      if (isMobile()) {
        zoom.reset(); // reinitialize to fit after rotation
        attemptHideIOSToolbar();
      } else {
        zoom.apply();
      }
    }, 150);
  }

  function setupLifecycle() {
    window.addEventListener('resize', handleResize);
    window.addEventListener('orientationchange', handleOrientationChange);
    if (window.screen && window.screen.orientation && window.screen.orientation.addEventListener) {
      window.screen.orientation.addEventListener('change', handleOrientationChange);
    }
    var img = document.querySelector('.mosaic-image');
    if (img && !img.complete) {
      img.addEventListener('load', function () {
        zoom.updateMinZoom();
        if (isMobile()) zoom.reset();
      });
    }
  }

  /* ----------------------------------------------------------------- *
   * Distance overlay (postMessage protocol with parent page)
   * ----------------------------------------------------------------- */
  var overlayVisible = false;

  function setOverlay(visible) {
    overlayVisible = visible;
    var overlay = document.getElementById('distance-overlay');
    if (overlay) overlay.classList.toggle('visible', visible);
    if (window.parent !== window) {
      window.parent.postMessage(
        { type: 'distanceOverlayToggled', visible: visible },
        '*'
      );
    }
  }

  window.addEventListener('message', function (e) {
    if (e.data && e.data.type === 'toggleDistanceOverlay') {
      setOverlay(!overlayVisible);
    }
  });

  /* ----------------------------------------------------------------- *
   * Tooltips: lazy image loading + edge-aware placement
   * ----------------------------------------------------------------- */
  function loadTooltipImage(region) {
    var img = region.querySelector('.tooltip-image');
    if (img && img.dataset.src && !img.src) {
      img.src = img.dataset.src;
      img.style.display = '';
    }
  }
  window.loadTooltipImage = loadTooltipImage;

  function positionTooltip(region) {
    var tooltip = region.querySelector('.tooltip');
    if (!tooltip) return;
    tooltip.classList.remove('tooltip-left', 'tooltip-top');
    var rect = region.getBoundingClientRect();
    if (rect.left > window.innerWidth * 0.6) tooltip.classList.add('tooltip-left');
    if (rect.top > window.innerHeight * 0.6) tooltip.classList.add('tooltip-top');
  }

  /* ----------------------------------------------------------------- *
   * Tile click: new tab (desktop) / modal (mobile)
   * ----------------------------------------------------------------- */
  function handleTileClick(region) {
    var url = region.dataset.clickUrl;
    if (isMobile()) {
      openMobileModal(region);
    } else if (url) {
      window.open(region.dataset.tileImage || url, '_blank');
    }
  }
  window.handleTileClick = handleTileClick;

  function openMobileModal(region) {
    var modal = document.getElementById('mobile-modal');
    var img = document.getElementById('modal-image');
    var info = document.getElementById('modal-info');
    if (!modal) return;
    if (img) img.src = region.dataset.tileImage || '';
    if (info) {
      /* EXIF dates are attacker-controlled bytes riding the tile images:
       * reading data-date-info back decodes the server-side attribute
       * escaping, so interpolating it into innerHTML (as the reference
       * JS does) is stored XSS on the hosting origin. Build with text
       * nodes instead — a reference bug deliberately not preserved. */
      info.textContent = '';
      info.appendChild(
        document.createTextNode(region.dataset.distanceInfo || '')
      );
      if (region.dataset.dateInfo) {
        var dateDiv = document.createElement('div');
        dateDiv.textContent = region.dataset.dateInfo;
        info.appendChild(dateDiv);
      }
    }
    modal.classList.add('visible');
  }

  function closeMobileModal() {
    var modal = document.getElementById('mobile-modal');
    if (modal) modal.classList.remove('visible');
  }
  window.closeMobileModal = closeMobileModal;

  /* ----------------------------------------------------------------- *
   * Year filter
   * ----------------------------------------------------------------- */
  function setupYearFilter() {
    var slider = document.getElementById('year-slider');
    var display = document.getElementById('year-display');
    if (!slider) return;
    var allValue = parseInt(slider.max, 10);

    function update() {
      var v = parseInt(slider.value, 10);
      var all = v >= allValue;
      if (display) display.textContent = all ? 'All Years' : String(v);
      var regions = document.querySelectorAll('.tile-region');
      for (var i = 0; i < regions.length; i++) {
        var y = regions[i].dataset.year;
        var match = all || y === String(v);
        regions[i].classList.toggle('disabled', !match);
      }
      var overlays = document.querySelectorAll('.distance-overlay-tile');
      void overlays; // overlay tiles are year-agnostic
    }
    slider.addEventListener('input', update);
    update();
  }

  /* ----------------------------------------------------------------- *
   * Rate limiter: 10 flags per minute, sliding window
   * ----------------------------------------------------------------- */
  function RateLimiter(maxPerMinute) {
    this.max = maxPerMinute || 10;
    this.times = [];
  }
  RateLimiter.prototype.allow = function () {
    var now = Date.now();
    this.times = this.times.filter(function (t) {
      return now - t < 60000;
    });
    if (this.times.length >= this.max) return false;
    this.times.push(now);
    return true;
  };

  /* ----------------------------------------------------------------- *
   * TileFlagSystem
   * ----------------------------------------------------------------- */
  var FlagSystem = {
    apiBase: window.MOSAIC_FLAG_API || null,
    cache: {}, // hash -> {flagged, ts}
    cacheTTL: 10000,
    pending: {}, // request de-dup
    limiter: new RateLimiter(10),

    localKey: function (hash) {
      return 'mosaic-flag-' + hash;
    },

    getLocal: function (hash) {
      try {
        return localStorage.getItem(this.localKey(hash)) !== null;
      } catch (e) {
        return false;
      }
    },

    setLocal: function (hash, flagged, path) {
      try {
        if (flagged) {
          localStorage.setItem(
            this.localKey(hash),
            JSON.stringify({ p: path || '', t: Date.now() })
          );
        } else {
          localStorage.removeItem(this.localKey(hash));
        }
      } catch (e) {
        /* storage unavailable */
      }
    },

    /* One-time migration of locally-stored flags to the server once an
     * API base is configured (reference behavior, mosaic-widget.js:1127-
     * 1210): POST each local flag; successes are removed locally,
     * failures stay for the next visit. */
    migrateLocalFlags: function () {
      if (!this.apiBase) return Promise.resolve(null);
      var entries = [];
      try {
        for (var i = 0; i < localStorage.length; i++) {
          var k = localStorage.key(i);
          if (k && k.indexOf('mosaic-flag-') === 0) {
            var hash = k.slice('mosaic-flag-'.length);
            var path = '';
            try {
              var v = JSON.parse(localStorage.getItem(k));
              if (v && v.p) path = v.p;
            } catch (e) {
              /* legacy '1' format: no path recorded */
            }
            entries.push({ hash: hash, path: path });
          }
        }
      } catch (e) {
        return Promise.resolve(null);
      }
      if (!entries.length) return Promise.resolve(null);
      showToast('Migrating ' + entries.length + ' saved flags to server...');
      var self = this;
      var ok = 0;
      var fail = 0;
      var chain = entries.reduce(function (p, ent) {
        return p.then(function () {
          return fetch(self.apiBase + '/tiles/' + ent.hash + '/flag', {
            method: 'POST',
            headers: { 'Content-Type': 'application/json' },
            body: JSON.stringify({ tilePath: ent.path }),
          })
            .then(function (r) {
              if (r.ok) {
                ok++;
                self.cache[ent.hash] = { flagged: true, ts: Date.now() };
                try {
                  localStorage.removeItem(self.localKey(ent.hash));
                } catch (e) {}
              } else {
                fail++;
              }
            })
            .catch(function () {
              fail++;
            });
        });
      }, Promise.resolve());
      return chain.then(function () {
        if (fail === 0 && ok > 0) {
          showToast('✅ Migrated ' + ok + ' flags to server');
        } else if (ok > 0) {
          showToast('⚠️ Migrated ' + ok + '/' + entries.length + ' flags (' + fail + ' failed)');
        } else {
          showToast('❌ Flag migration failed (keeping local copies)');
        }
        return { ok: ok, fail: fail };
      });
    },

    isFlagged: function (hash) {
      var c = this.cache[hash];
      if (c && Date.now() - c.ts < this.cacheTTL) {
        return Promise.resolve(c.flagged);
      }
      if (!this.apiBase) return Promise.resolve(this.getLocal(hash));
      if (this.pending[hash]) return this.pending[hash];
      var self = this;
      var p = fetch(this.apiBase + '/tiles/flags', {
        method: 'POST',
        headers: { 'Content-Type': 'application/json' },
        body: JSON.stringify({ tileHashes: [hash] }),
      })
        .then(function (r) {
          return r.json();
        })
        .then(function (data) {
          var flagged = !!(data && data.flags && data.flags[hash]);
          self.cache[hash] = { flagged: flagged, ts: Date.now() };
          delete self.pending[hash];
          return flagged;
        })
        .catch(function () {
          delete self.pending[hash];
          return self.getLocal(hash);
        });
      this.pending[hash] = p;
      return p;
    },

    toggle: function (hash, path) {
      var self = this;
      if (!this.limiter.allow()) {
        return Promise.resolve({ error: 'Rate limit: max 10 flags per minute' });
      }
      return this.isFlagged(hash).then(function (flagged) {
        var next = !flagged;
        self.cache[hash] = { flagged: next, ts: Date.now() };
        self.setLocal(hash, next, path);
        if (!self.apiBase) return { flagged: next };
        return fetch(self.apiBase + '/tiles/' + hash + '/flag', {
          method: next ? 'POST' : 'DELETE',
          headers: { 'Content-Type': 'application/json' },
          body: next ? JSON.stringify({ tilePath: path || '' }) : undefined,
        })
          .then(function (r) {
            if (!r.ok) throw new Error('flag API error ' + r.status);
            return { flagged: next };
          })
          .catch(function (err) {
            return { flagged: next, offline: true, error: String(err) };
          });
      });
    },
  };

  /* transient status toast (bottom of the viewport) */
  var toastTimer = null;
  function showToast(msg) {
    var el = document.getElementById('mosaic-toast');
    if (!el) {
      el = document.createElement('div');
      el.id = 'mosaic-toast';
      el.className = 'mosaic-toast';
      document.body.appendChild(el);
    }
    el.textContent = msg;
    el.classList.add('visible');
    clearTimeout(toastTimer);
    toastTimer = setTimeout(function () {
      el.classList.remove('visible');
    }, 3000);
  }

  function updateFlagUI(hash, flagged) {
    var btn = document.getElementById('flag-btn-' + hash);
    var status = document.getElementById('flag-status-' + hash);
    if (btn) btn.textContent = flagged ? '✅ Flagged' : '🚩 Flag for Review';
    if (status) status.textContent = flagged ? 'Flagged for review' : '';
  }

  function toggleFlag(hash, path) {
    FlagSystem.toggle(hash, path).then(function (res) {
      if (res && res.error && res.flagged === undefined) {
        var status = document.getElementById('flag-status-' + hash);
        if (status) status.textContent = res.error;
        return;
      }
      updateFlagUI(hash, res.flagged);
    });
  }
  window.toggleFlag = toggleFlag;

  /* ----------------------------------------------------------------- *
   * Wiring
   * ----------------------------------------------------------------- */
  function init() {
    setupZoom();
    setupLifecycle();
    attemptHideIOSToolbar();
    zoom.updateMinZoom();
    if (isMobile()) zoom.reset(); // initialize mobile view at fit zoom
    setupYearFilter();
    FlagSystem.migrateLocalFlags().then(function (res) {
      if (res && res.ok) {
        var regions = document.querySelectorAll('.tile-region');
        for (var i = 0; i < regions.length; i++) {
          var h = regions[i].dataset.tileHash;
          if (h && FlagSystem.cache[h] && FlagSystem.cache[h].flagged) {
            updateFlagUI(h, true);
          }
        }
      }
    });
    var regions = document.querySelectorAll('.tile-region');
    for (var i = 0; i < regions.length; i++) {
      (function (region) {
        region.addEventListener('mouseenter', function () {
          loadTooltipImage(region);
          positionTooltip(region);
        });
        region.addEventListener('click', function (e) {
          if (e.target.closest('.flag-button')) return;
          handleTileClick(region);
        });
        var btn = region.querySelector('.flag-button');
        if (btn) {
          btn.addEventListener('click', function (e) {
            e.stopPropagation();
            toggleFlag(region.dataset.tileHash, region.dataset.tilePath);
          });
        }
        var hash = region.dataset.tileHash;
        if (hash && FlagSystem.getLocal(hash)) updateFlagUI(hash, true);
      })(regions[i]);
    }
  }

  if (document.readyState === 'loading') {
    document.addEventListener('DOMContentLoaded', init);
  } else {
    init();
  }
})();
