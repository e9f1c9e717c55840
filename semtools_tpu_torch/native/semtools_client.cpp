// semtools-client: the native daemon client of the PyTorch port.
//
// A forwarded command from the Python CLI still pays the interpreter's
// start-up and imports in a new process, though the daemon already holds
// the model, the kernels and the workspace corpus on the card. This client
// speaks the daemon's newline-delimited-JSON protocol
// (semtools_tpu_torch/daemon.py) directly over the port's unix socket,
// daemon-torch.sock, and never starts Python. When no daemon is reachable,
// for `daemon` management commands, or when the daemon answers busy, it
// execs `$SEMTOOLS_TPU_PYTHON -m semtools_tpu_torch.cli` (python3 by
// default), so it is a drop-in `semtools` for the port. It never reaches the
// JAX package: neither its socket (daemon.sock) nor its CLI.
//
// Protocol and semantics as semtools_tpu_torch/daemon.py:
//   -> {"argv": [...], "stdin": "..."|null, "cwd": "...", "env": {...}}
//   <- {"stdout": "...", "stderr": "...", "exit": 0}
// Env forwarding: the SEMTOOLS_* namespace (minus the daemon's own control
// knobs) plus OPENAI_API_KEY/OPENAI_BASE_URL/LLAMA_CLOUD_API_KEY/HOME,
// null when unset (daemon.py: _env_key_forwardable, forward()).
//
// Build: semtools_tpu_torch.utils.native.build_client() (g++ -O2 -std=c++17
// into semtools_tpu_torch/_build/semtools-client).

#include <sys/socket.h>
#include <sys/types.h>
#include <sys/un.h>
#include <sys/wait.h>
#include <unistd.h>

#include <cerrno>
#include <csignal>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern char **environ;

namespace {

// ---------------------------------------------------------------------------
// JSON writing

// Length of the valid UTF-8 sequence at s[i] (1-4), or 0 when s[i] starts
// no valid sequence (stray continuation byte, overlong form, surrogate
// range, truncated tail) — exactly the bytes Python's strict UTF-8
// decoder rejects.
size_t utf8_seq_len(const std::string &s, size_t i) {
  unsigned char c0 = static_cast<unsigned char>(s[i]);
  if (c0 < 0x80) return 1;
  auto cont = [&](size_t k, unsigned char lo, unsigned char hi) {
    if (i + k >= s.size()) return false;
    unsigned char c = static_cast<unsigned char>(s[i + k]);
    return c >= lo && c <= hi;
  };
  if (c0 >= 0xC2 && c0 <= 0xDF)
    return cont(1, 0x80, 0xBF) ? 2 : 0;
  if (c0 == 0xE0)
    return cont(1, 0xA0, 0xBF) && cont(2, 0x80, 0xBF) ? 3 : 0;
  if ((c0 >= 0xE1 && c0 <= 0xEC) || c0 == 0xEE || c0 == 0xEF)
    return cont(1, 0x80, 0xBF) && cont(2, 0x80, 0xBF) ? 3 : 0;
  if (c0 == 0xED)  // exclude UTF-16 surrogates U+D800..DFFF
    return cont(1, 0x80, 0x9F) && cont(2, 0x80, 0xBF) ? 3 : 0;
  if (c0 == 0xF0)
    return cont(1, 0x90, 0xBF) && cont(2, 0x80, 0xBF) && cont(3, 0x80, 0xBF) ? 4 : 0;
  if (c0 >= 0xF1 && c0 <= 0xF3)
    return cont(1, 0x80, 0xBF) && cont(2, 0x80, 0xBF) && cont(3, 0x80, 0xBF) ? 4 : 0;
  if (c0 == 0xF4)
    return cont(1, 0x80, 0x8F) && cont(2, 0x80, 0xBF) && cont(3, 0x80, 0xBF) ? 4 : 0;
  return 0;
}

void json_escape_to(std::string &out, const std::string &s) {
  out += '"';
  for (size_t i = 0; i < s.size();) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    switch (c) {
      case '"': out += "\\\""; ++i; continue;
      case '\\': out += "\\\\"; ++i; continue;
      case '\b': out += "\\b"; ++i; continue;
      case '\f': out += "\\f"; ++i; continue;
      case '\n': out += "\\n"; ++i; continue;
      case '\r': out += "\\r"; ++i; continue;
      case '\t': out += "\\t"; ++i; continue;
      default: break;
    }
    if (c < 0x20) {
      char buf[8];
      std::snprintf(buf, sizeof buf, "\\u%04x", c);
      out += buf;
      ++i;
      continue;
    }
    if (c < 0x80) {
      out += static_cast<char>(c);
      ++i;
      continue;
    }
    // Python's argv/env decoding is surrogateescape: a byte that is not
    // part of a valid UTF-8 sequence becomes U+DC80+byte, which
    // json.dumps emits as \udcXX and the daemon's json.loads restores.
    // Emitting the raw byte instead would make the daemon reject the
    // whole request ("bad request") where the Python client succeeds.
    size_t n = utf8_seq_len(s, i);
    if (n == 0) {
      char buf[8];
      std::snprintf(buf, sizeof buf, "\\udc%02x", c);
      out += buf;
      ++i;
    } else {
      out.append(s, i, n);
      i += n;
    }
  }
  out += '"';
}

// ---------------------------------------------------------------------------
// JSON reading (the response is json.dumps output: ASCII with \u escapes)

struct JsonParser {
  const std::string &s;
  size_t i = 0;
  bool ok = true;

  explicit JsonParser(const std::string &str) : s(str) {}

  void ws() {
    while (i < s.size() && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n' || s[i] == '\r')) ++i;
  }
  bool eat(char c) {
    ws();
    if (i < s.size() && s[i] == c) { ++i; return true; }
    ok = false;
    return false;
  }
  void utf8_append(std::string &out, uint32_t cp) {
    if (cp >= 0xDC80 && cp <= 0xDCFF) {
      // lone low surrogate = Python surrogateescape for one raw byte
      // (json.dumps of undecodable argv/env/output bytes): restore it
      out += static_cast<char>(cp & 0xFF);
      return;
    }
    if (cp < 0x80) out += static_cast<char>(cp);
    else if (cp < 0x800) {
      out += static_cast<char>(0xC0 | (cp >> 6));
      out += static_cast<char>(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      out += static_cast<char>(0xE0 | (cp >> 12));
      out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      out += static_cast<char>(0x80 | (cp & 0x3F));
    } else {
      out += static_cast<char>(0xF0 | (cp >> 18));
      out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
      out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      out += static_cast<char>(0x80 | (cp & 0x3F));
    }
  }
  uint32_t hex4() {
    uint32_t v = 0;
    for (int k = 0; k < 4 && i < s.size(); ++k, ++i) {
      char c = s[i];
      v <<= 4;
      if (c >= '0' && c <= '9') v |= static_cast<uint32_t>(c - '0');
      else if (c >= 'a' && c <= 'f') v |= static_cast<uint32_t>(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') v |= static_cast<uint32_t>(c - 'A' + 10);
      else { ok = false; return 0; }
    }
    return v;
  }
  std::string parse_string() {
    std::string out;
    if (!eat('"')) return out;
    while (i < s.size() && s[i] != '"') {
      char c = s[i++];
      if (c != '\\') { out += c; continue; }
      if (i >= s.size()) { ok = false; break; }
      char e = s[i++];
      switch (e) {
        case '"': out += '"'; break;
        case '\\': out += '\\'; break;
        case '/': out += '/'; break;
        case 'b': out += '\b'; break;
        case 'f': out += '\f'; break;
        case 'n': out += '\n'; break;
        case 'r': out += '\r'; break;
        case 't': out += '\t'; break;
        case 'u': {
          uint32_t cp = hex4();
          if (cp >= 0xD800 && cp <= 0xDBFF && i + 1 < s.size() && s[i] == '\\' && s[i + 1] == 'u') {
            i += 2;  // low surrogate follows
            uint32_t lo = hex4();
            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
          }
          utf8_append(out, cp);
          break;
        }
        default: ok = false; return out;
      }
    }
    eat('"');
    return out;
  }
  void skip_value();
  void skip_object() {
    eat('{');
    ws();
    if (i < s.size() && s[i] == '}') { ++i; return; }
    while (ok) {
      parse_string();
      eat(':');
      skip_value();
      ws();
      if (i < s.size() && s[i] == ',') { ++i; continue; }
      break;
    }
    eat('}');
  }
  void skip_array() {
    eat('[');
    ws();
    if (i < s.size() && s[i] == ']') { ++i; return; }
    while (ok) {
      skip_value();
      ws();
      if (i < s.size() && s[i] == ',') { ++i; continue; }
      break;
    }
    eat(']');
  }
};

void JsonParser::skip_value() {
  ws();
  if (i >= s.size()) { ok = false; return; }
  char c = s[i];
  if (c == '"') { parse_string(); return; }
  if (c == '{') { skip_object(); return; }
  if (c == '[') { skip_array(); return; }
  // number / true / false / null
  while (i < s.size() && s[i] != ',' && s[i] != '}' && s[i] != ']' &&
         s[i] != ' ' && s[i] != '\n' && s[i] != '\t' && s[i] != '\r')
    ++i;
}

// Extract "stdout"/"stderr"/"exit" from the one-line response object.
bool parse_response(const std::string &line, std::string &out, std::string &err, long &code) {
  JsonParser p(line);
  bool have_exit = false;
  if (!p.eat('{')) return false;
  p.ws();
  if (p.i < line.size() && line[p.i] == '}') return false;
  while (p.ok) {
    std::string key = p.parse_string();
    if (!p.eat(':')) break;
    if (key == "stdout") out = p.parse_string();
    else if (key == "stderr") err = p.parse_string();
    else if (key == "exit") {
      p.ws();
      char *end = nullptr;
      code = std::strtol(line.c_str() + p.i, &end, 10);
      if (end == line.c_str() + p.i) { p.ok = false; break; }
      p.i = static_cast<size_t>(end - line.c_str());
      have_exit = true;
    } else p.skip_value();
    p.ws();
    if (p.i < line.size() && line[p.i] == ',') { ++p.i; continue; }
    break;
  }
  return p.ok && have_exit;
}

// ---------------------------------------------------------------------------
// Daemon semantics (as semtools_tpu_torch/daemon.py)

std::string socket_path() {
  const char *dir = std::getenv("SEMTOOLS_TPU_DAEMON_DIR");
  if (dir && *dir) return std::string(dir) + "/daemon-torch.sock";
  const char *home = std::getenv("HOME");
  return std::string(home ? home : ".") + "/.semtools/daemon-torch.sock";
}

bool env_key_forwardable(const std::string &key) {
  if (key == "SEMTOOLS_TPU_DAEMON" || key == "SEMTOOLS_TPU_DAEMON_DIR") return false;
  if (key.rfind("SEMTOOLS_", 0) == 0) return true;
  return key == "OPENAI_API_KEY" || key == "OPENAI_BASE_URL" ||
         key == "LLAMA_CLOUD_API_KEY" || key == "HOME";
}

long forward_timeout_s(const std::vector<std::string> &argv) {
  // Uniformly long, as daemon.py's _FORWARD_TIMEOUT_S: abandoning the
  // socket mid-command just duplicates the work locally while the daemon
  // keeps running it under the store lock.
  (void)argv;
  return 4 * 3600;
}

std::string build_request(const std::vector<std::string> &argv,
                          const std::string *stdin_text) {
  std::string req = "{\"argv\": [";
  for (size_t k = 0; k < argv.size(); ++k) {
    if (k) req += ", ";
    json_escape_to(req, argv[k]);
  }
  req += "], \"stdin\": ";
  if (stdin_text) json_escape_to(req, *stdin_text);
  else req += "null";
  req += ", \"cwd\": ";
  char cwd[4096];
  json_escape_to(req, getcwd(cwd, sizeof cwd) ? std::string(cwd) : std::string("."));
  req += ", \"env\": {";
  bool first = true;
  for (char **e = environ; *e; ++e) {
    const char *eq = std::strchr(*e, '=');
    if (!eq) continue;
    std::string key(*e, static_cast<size_t>(eq - *e));
    if (!env_key_forwardable(key)) continue;
    if (!first) req += ", ";
    first = false;
    json_escape_to(req, key);
    req += ": ";
    json_escape_to(req, std::string(eq + 1));
  }
  // credentials + HOME are always present, null when unset (daemon.py
  // treats the request env as authoritative for them)
  for (const char *key : {"OPENAI_API_KEY", "OPENAI_BASE_URL",
                          "LLAMA_CLOUD_API_KEY", "HOME"}) {
    if (std::getenv(key)) continue;  // already emitted above
    if (!first) req += ", ";
    first = false;
    json_escape_to(req, std::string(key));
    req += ": null";
  }
  req += "}}\n";
  return req;
}

// Try one request round-trip; returns false when the daemon is unreachable
// or replies garbage (caller falls back to the Python CLI).
bool daemon_roundtrip(const std::string &request, long timeout_s,
                      std::string &out, std::string &err, long &code) {
  std::string path = socket_path();
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return false;
  struct timeval tv = {timeout_s, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  struct sockaddr_un addr;
  std::memset(&addr, 0, sizeof addr);
  addr.sun_family = AF_UNIX;
  if (path.size() >= sizeof addr.sun_path) { ::close(fd); return false; }
  std::strncpy(addr.sun_path, path.c_str(), sizeof addr.sun_path - 1);
  if (::connect(fd, reinterpret_cast<struct sockaddr *>(&addr), sizeof addr) != 0) {
    ::close(fd);
    return false;
  }
  size_t sent = 0;
  while (sent < request.size()) {
    ssize_t n = ::send(fd, request.data() + sent, request.size() - sent, 0);
    if (n <= 0) { ::close(fd); return false; }
    sent += static_cast<size_t>(n);
  }
  std::string resp;
  char buf[1 << 16];
  while (resp.empty() || resp.back() != '\n') {
    ssize_t n = ::recv(fd, buf, sizeof buf, 0);
    if (n <= 0) break;
    resp.append(buf, static_cast<size_t>(n));
  }
  ::close(fd);
  if (resp.empty() || resp.back() != '\n') return false;
  return parse_response(resp, out, err, code);
}

// ---------------------------------------------------------------------------
// Python fallback

[[noreturn]] void exec_python(const std::vector<std::string> &argv,
                              const std::string *consumed_stdin,
                              bool disable_daemon = false) {
  if (disable_daemon) {
    // The daemon already answered busy (or the socket round-trip
    // failed): the Python CLI must run the command locally, not pay a
    // second forward attempt + busy wait against the same daemon.
    setenv("SEMTOOLS_TPU_DAEMON", "off", 1);
  }
  const char *py = std::getenv("SEMTOOLS_TPU_PYTHON");
  if (!py || !*py) py = "python3";
  std::vector<const char *> cargv = {py, "-m", "semtools_tpu_torch.cli"};
  for (const auto &a : argv) cargv.push_back(a.c_str());
  cargv.push_back(nullptr);
  if (consumed_stdin) {
    // stdin was already drained for the daemon request: re-feed it to the
    // child through a pipe so local execution sees the same bytes
    int pfd[2];
    if (pipe(pfd) == 0) {
      pid_t pid = fork();
      if (pid == 0) {
        ::close(pfd[1]);
        dup2(pfd[0], 0);
        ::close(pfd[0]);
        execvp(py, const_cast<char *const *>(cargv.data()));
        std::perror("semtools-client: exec python");
        _exit(127);
      }
      if (pid > 0) {
        ::close(pfd[0]);
        size_t off = 0;
        while (off < consumed_stdin->size()) {
          ssize_t n = ::write(pfd[1], consumed_stdin->data() + off,
                              consumed_stdin->size() - off);
          if (n <= 0) break;
          off += static_cast<size_t>(n);
        }
        ::close(pfd[1]);
        int status = 0;
        waitpid(pid, &status, 0);
        std::exit(WIFEXITED(status) ? WEXITSTATUS(status) : 1);
      }
    }
  }
  execvp(py, const_cast<char *const *>(cargv.data()));
  std::perror("semtools-client: exec python");
  std::exit(127);
}

}  // namespace

int main(int argc, char **argv) {
  // A daemon that dies mid-request (or a Python child exiting before
  // draining re-fed stdin) must surface as a write error, not kill this
  // process with SIGPIPE — exit 141 would lose the fallback path and
  // the child's real exit status.
  std::signal(SIGPIPE, SIG_IGN);
  std::vector<std::string> args(argv + 1, argv + argc);

  const char *mode_c = std::getenv("SEMTOOLS_TPU_DAEMON");
  std::string mode = mode_c ? mode_c : "auto";
  for (auto &ch : mode) ch = static_cast<char>(std::tolower(ch));

  bool manage = !args.empty() && args[0] == "daemon";
  bool disabled = mode == "0" || mode == "off" || mode == "never" || mode.empty();
  if (manage || disabled) exec_python(args, nullptr);

  // stdin: same rule as the Python client (cli.py main): read it all
  // when it is not a TTY, else null
  std::string stdin_text;
  bool have_stdin = !isatty(0);
  if (have_stdin) {
    char buf[1 << 16];
    ssize_t n;
    while ((n = ::read(0, buf, sizeof buf)) > 0)
      stdin_text.append(buf, static_cast<size_t>(n));
  }

  std::string request = build_request(args, have_stdin ? &stdin_text : nullptr);
  std::string out, err;
  long code = 1;
  if (daemon_roundtrip(request, forward_timeout_s(args), out, err, code)) {
    if (!out.empty()) fwrite(out.data(), 1, out.size(), stdout);
    if (!err.empty()) fwrite(err.data(), 1, err.size(), stderr);
    return static_cast<int>(code);
  }
  // no daemon, a torn reply, or {"busy": true} (no "exit" key — the
  // daemon is mid-command and never started ours): run locally through
  // the Python CLI, with its own daemon forwarding disabled
  exec_python(args, have_stdin ? &stdin_text : nullptr, /*disable_daemon=*/true);
}
