/* gpu-checkpoint: suspend, dump and resume one GPU workload's device state
 * by pid.
 *
 * The port's counterpart of the JAX package's tpu-checkpoint CLI, and the
 * role NVIDIA's cuda-checkpoint plays for a CRIU plugin: a small tool the
 * node agent or the CRIU plugin (criu_gpu_plugin.c) execs. The path is
 * cooperative. The workload's agentlet (grit_tpu_torch/device/agentlet.py)
 * serves a JSON protocol on ${GRIT_TPU_SOCKET_DIR:-/tmp}/grit-tpu-<pid>.sock
 * and parks the training loop at a step boundary, where no kernel or
 * collective of the step is in flight; the device state leaves the card in
 * the agentlet's snapshot, never in the process image.
 *
 * Usage:
 *   gpu-checkpoint --toggle  --pid <pid>      quiesce if running,
 *                                             resume if quiesced
 *   gpu-checkpoint --quiesce --pid <pid> [--timeout <sec>]
 *   gpu-checkpoint --dump    --pid <pid> --dir <path> [--base <path>]
 *     (--base: a delta dump against a committed base snapshot: pre-copy)
 *   gpu-checkpoint --resume  --pid <pid>
 *   gpu-checkpoint --status  --pid <pid>
 *
 * The agentlet's JSON reply is printed on stdout. Exit code 0 when the
 * reply says ok, 1 when the agentlet cannot be reached or answers with an
 * error, 2 on a usage error. The pid is the one the agentlet names its
 * socket with, as the JAX package's CLI takes it.
 */

#include <errno.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

static void sock_path(long pid, char *out, size_t n) {
  const char *dir = getenv("GRIT_TPU_SOCKET_DIR");
  if (!dir || !*dir) dir = "/tmp";
  snprintf(out, n, "%s/grit-tpu-%ld.sock", dir, pid);
}

static int connect_agentlet(long pid) {
  struct sockaddr_un addr;
  char path[4096];
  sock_path(pid, path, sizeof(path));
  if (strlen(path) >= sizeof(addr.sun_path)) {
    errno = ENAMETOOLONG;
    return -1;
  }
  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  memcpy(addr.sun_path, path, strlen(path) + 1);
  if (connect(fd, (struct sockaddr *)&addr, sizeof(addr)) != 0) {
    int saved = errno;
    close(fd);
    errno = saved;
    return -1;
  }
  return fd;
}

/* Send one JSON request line and read one reply line into a malloc'd
 * string (the caller frees it). NULL on a transport error. */
static char *roundtrip(int fd, const char *req) {
  size_t len = strlen(req);
  char *line = malloc(len + 2);
  if (!line) return NULL;
  memcpy(line, req, len);
  line[len] = '\n';
  line[len + 1] = '\0';
  size_t sent = 0;
  while (sent < len + 1) {
    ssize_t w = write(fd, line + sent, len + 1 - sent);
    if (w < 0) {
      if (errno == EINTR) continue;
      free(line);
      return NULL;
    }
    sent += (size_t)w;
  }
  free(line);

  size_t cap = 4096, used = 0;
  char *reply = malloc(cap);
  if (!reply) return NULL;
  for (;;) {
    if (used + 4096 + 1 > cap) {
      cap *= 2;
      char *grown = realloc(reply, cap);
      if (!grown) {
        free(reply);
        return NULL;
      }
      reply = grown;
    }
    ssize_t r = read(fd, reply + used, 4096);
    if (r < 0) {
      if (errno == EINTR) continue;
      free(reply);
      return NULL;
    }
    if (r == 0) break;
    used += (size_t)r;
    reply[used] = '\0';
    char *nl = memchr(reply, '\n', used);
    if (nl) {
      *nl = '\0';
      return reply;
    }
  }
  if (used == 0) {
    free(reply);
    return NULL;
  }
  reply[used] = '\0';
  return reply;
}

static int reply_ok(const char *reply) {
  return strstr(reply, "\"ok\": true") != NULL ||
         strstr(reply, "\"ok\":true") != NULL;
}

/* A JSON string literal's body for a path: quotes, backslashes and control
 * characters escaped. The caller frees it. */
static char *json_escape(const char *s) {
  size_t n = strlen(s);
  char *out = malloc(6 * n + 1);
  if (!out) return NULL;
  char *o = out;
  for (const unsigned char *p = (const unsigned char *)s; *p; p++) {
    if (*p == '"' || *p == '\\') {
      *o++ = '\\';
      *o++ = (char)*p;
    } else if (*p < 0x20) {
      o += sprintf(o, "\\u%04x", *p);
    } else {
      *o++ = (char)*p;
    }
  }
  *o = '\0';
  return out;
}

static int usage(void) {
  fprintf(stderr,
          "usage: gpu-checkpoint --toggle|--quiesce|--dump|--resume|--status "
          "--pid <pid> [--dir <path>] [--base <path>] [--timeout <sec>]\n");
  return 2;
}

int main(int argc, char **argv) {
  const char *action = NULL;
  long pid = -1;
  const char *dir = NULL;
  const char *base = NULL;
  double timeout = 300.0;

  for (int i = 1; i < argc; i++) {
    const char *a = argv[i];
    if (!strcmp(a, "--toggle") || !strcmp(a, "--quiesce") ||
        !strcmp(a, "--dump") || !strcmp(a, "--resume") ||
        !strcmp(a, "--status")) {
      action = a + 2;
    } else if (!strcmp(a, "--pid") && i + 1 < argc) {
      pid = strtol(argv[++i], NULL, 10);
    } else if (!strcmp(a, "--dir") && i + 1 < argc) {
      dir = argv[++i];
    } else if (!strcmp(a, "--base") && i + 1 < argc) {
      base = argv[++i];
    } else if (!strcmp(a, "--timeout") && i + 1 < argc) {
      timeout = strtod(argv[++i], NULL);
    } else {
      return usage();
    }
  }
  if (!action || pid <= 0) return usage();
  if (!strcmp(action, "dump") && !dir) return usage();

  int fd = connect_agentlet(pid);
  if (fd < 0) {
    char path[4096];
    sock_path(pid, path, sizeof(path));
    fprintf(stderr,
            "gpu-checkpoint: cannot reach agentlet for pid %ld (%s): %s\n",
            pid, path, strerror(errno));
    return 1;
  }

  char *req = NULL;
  if (!strcmp(action, "toggle")) {
    /* The direction comes from the status, as cuda-checkpoint's single
     * flag does. */
    char *st = roundtrip(fd, "{\"op\": \"status\"}");
    int paused = st && strstr(st, "\"paused\": true") != NULL;
    free(st);
    req = strdup(paused ? "{\"op\": \"resume\"}" : "{\"op\": \"quiesce\"}");
  } else if (!strcmp(action, "dump")) {
    char *d = json_escape(dir);
    char *b = base ? json_escape(base) : NULL;
    size_t n = 64 + (d ? strlen(d) : 0) + (b ? strlen(b) : 0);
    req = malloc(n);
    if (req && d) {
      if (b)
        snprintf(req, n, "{\"op\": \"dump\", \"dir\": \"%s\", \"base\": \"%s\"}",
                 d, b);
      else
        snprintf(req, n, "{\"op\": \"dump\", \"dir\": \"%s\"}", d);
    }
    free(d);
    free(b);
  } else if (!strcmp(action, "quiesce")) {
    req = malloc(96);
    if (req)
      snprintf(req, 96, "{\"op\": \"quiesce\", \"timeout\": %.1f}", timeout);
  } else {
    req = malloc(64);
    if (req) snprintf(req, 64, "{\"op\": \"%s\"}", action);
  }
  if (!req) {
    close(fd);
    fprintf(stderr, "gpu-checkpoint: out of memory\n");
    return 1;
  }

  char *reply = roundtrip(fd, req);
  free(req);
  close(fd);
  if (!reply || !*reply) {
    free(reply);
    fprintf(stderr, "gpu-checkpoint: transport error talking to pid %ld\n",
            pid);
    return 1;
  }
  printf("%s\n", reply);
  int rc = reply_ok(reply) ? 0 : 1;
  free(reply);
  return rc;
}
